"""Lint runner: map files to rule-relative paths, run rules, report.

Path convention: rules scope themselves by *relpath* — the path under
``src/repro_torch/`` (``engine/backends/segment.py``) so the same rule set
applies to the package and to test fixtures (whose directories mirror
the hot-path layout under ``fixtures/lint/``).  ``"src/repro/"`` is not a
substring of ``"src/repro_torch/"``, so the port's anchor never matches a
JAX-package path by accident, nor the other way round.

Stdlib only: linting imports neither ``torch`` nor the package's runtime.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ModuleContext, Rule, all_rules

# markers whose trailing path fragment becomes the rule-relative path
_ANCHORS = ("src/repro_torch/", "fixtures/lint/")


def rule_relpath(path: Path) -> str:
    """Rule-relative posix path for ``path`` (see module docstring)."""
    posix = Path(path).as_posix()
    for anchor in _ANCHORS:
        idx = posix.rfind(anchor)
        if idx >= 0:
            return posix[idx + len(anchor):]
    return Path(path).name


def lint_source(source: str, relpath: str,
                rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Run the rules over one module's source. Returns ALL findings,
    suppressed ones included (callers filter on ``.suppressed``)."""
    if rules is None:
        rules = all_rules()
    try:
        ctx = ModuleContext.from_source(source, relpath)
    except SyntaxError as e:
        return [Finding(rule="E000", path=relpath, line=e.lineno or 1,
                        col=(e.offset or 1) - 1,
                        message=f"syntax error: {e.msg}")]
    findings: list[Finding] = []
    for rule in rules:
        if rule.applies(relpath):
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_py_files(paths: Iterable[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(paths: Iterable[Path],
               rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Lint every ``.py`` under ``paths`` (dirs recursed, sorted)."""
    if rules is None:
        rules = all_rules()
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(
            lint_source(f.read_text(), rule_relpath(f), rules))
    return findings

