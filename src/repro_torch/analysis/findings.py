"""Finding / baseline plumbing shared by the linter and its CLI.

A :class:`Finding` is one rule violation anchored to ``path:line:col``.
Baselines let a strict CI gate coexist with known, justified debt: a
finding whose ``(rule, path, message)`` identity appears in the committed
baseline file is reported but does not fail ``--strict``.  Line numbers
are deliberately *not* part of the identity — unrelated edits above a
baselined finding must not resurrect it.

The port's own copy of ``repro.analysis.findings``: the baseline JSON is
the JAX package's format byte for byte, so a baseline written by either
package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str       # "R001" .. "R006" ("E000": a syntax error)
    path: str       # repo-relative posix path of the offending file
    line: int       # 1-based
    col: int        # 0-based (ast convention)
    message: str
    suppressed: bool = False   # matched an inline `# lint: <tag>-ok`

    def identity(self) -> tuple[str, str, str]:
        """Baseline identity: stable across unrelated line shifts."""
        return (self.rule, self.path, self.message)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed}


class Baseline:
    """Committed set of accepted finding identities."""

    def __init__(self, entries: Iterable[dict] | None = None):
        self._identities: set[tuple[str, str, str]] = set()
        for e in entries or ():
            self._identities.add((e["rule"], e["path"], e["message"]))

    def __len__(self) -> int:
        return len(self._identities)

    def __contains__(self, finding: Finding) -> bool:
        return finding.identity() in self._identities

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, list):
            raise ValueError(f"baseline {path} must be a JSON list of "
                             "{rule, path, message} entries")
        return cls(data)

    @staticmethod
    def dump(findings: Iterable[Finding], path: str) -> int:
        """Write the given findings as a fresh baseline; returns the count."""
        entries = sorted(
            {f.identity() for f in findings})
        payload = [{"rule": r, "path": p, "message": m}
                   for (r, p, m) in entries]
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
        return len(payload)
