"""R002 — plan-rebuild hazard: ad-hoc executables and stringified keys.

One plan per shape bucket is the engine's core perf contract: a stream
of same-bucket graphs builds each backend stage once
(``tests/test_torch_engine.py`` pins it; the trace auditor generalizes
it).  The port's counterparts of the JAX package's two hazards:

* **an ad-hoc executable outside the compile-owning modules** —
  ``torch.compile`` / ``torch.jit.*`` compiles per new shape or guard, and
  ``ctypes.CDLL`` or a call of ``kernels.build.build`` /
  ``load_library`` builds or loads kernel code; made in glue or entry-point
  code, each keys on raw Python shapes (or on nothing) instead of going
  through ``engine/bucketing.py`` and the plan cache.  The modules whose
  purpose is building executables (``engine/backends/``, ``kernels/``,
  ``core/``, and the JAX package's ``parallel/``, ``models/``,
  ``train/``, ``optim/`` for the modules still to port) are allowlisted;
* **stringified plan-cache keys** — an f-string / ``str()`` /
  ``.format()`` key handed to ``PlanCache.get_or_build`` collapses
  structurally different statics into one string (or embeds a repr that
  differs per object identity).  Keys stay structured hashable tuples
  (a ``torch.device`` is one) so bucket and config equality drive reuse.

Justified one-off executables carry ``# lint: retrace-ok — <why>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import ModuleContext, Rule, dotted_name

_COMPILE_OWNING = ("engine/backends/", "kernels/", "core/",
                   "parallel/", "models/", "train/", "optim/")


def _compile_name(name: str) -> bool:
    """``torch.compile``, ``torch.jit.*``, ``ctypes.CDLL`` or a build or
    load of the kernel library (``kernels.build.build`` /
    ``load_library``)."""
    return (name in ("torch.compile", "ctypes.CDLL", "load_library")
            or name.startswith("torch.jit.")
            or name.endswith((".build.build", ".load_library")))


def _is_compile_site(node: ast.AST) -> bool:
    name = dotted_name(node)
    if name is not None and _compile_name(name):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name is not None and _compile_name(name):
            return True
        if name in ("partial", "functools.partial") and node.args:
            inner = dotted_name(node.args[0])
            return inner is not None and _compile_name(inner)
    return False


def _stringified(node: ast.AST) -> str | None:
    """Describe the first string-building construct under ``node``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.JoinedStr):
            return "f-string"
        if isinstance(sub, ast.Call):
            if isinstance(sub.func, ast.Name) and sub.func.id in ("str",
                                                                  "repr"):
                return f"{sub.func.id}()"
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "format":
                return ".format()"
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod):
            left = sub.left
            if isinstance(left, ast.Constant) and isinstance(left.value, str):
                return "%-format"
    return None


class RetraceRule(Rule):
    id = "R002"
    tag = "retrace"
    description = ("plan-rebuild hazards: torch.compile / torch.jit / "
                   "kernel-library builds outside compile-owning modules "
                   "and stringified plan-cache keys bypassing bucketing")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        if not ctx.relpath.startswith(_COMPILE_OWNING):
            findings.extend(self._check_adhoc_compile(ctx))
        findings.extend(self._check_cache_keys(ctx))
        return findings

    def _check_adhoc_compile(self, ctx: ModuleContext) -> list[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            site = None
            if isinstance(node, ast.FunctionDef):
                for deco in node.decorator_list:
                    if _is_compile_site(deco):
                        site = deco
                        break
            elif isinstance(node, ast.Call) and _is_compile_site(node):
                site = node
            if site is not None:
                what = dotted_name(site.func if isinstance(site, ast.Call)
                                   else site)
                out.append(self.finding(
                    ctx, site,
                    f"executable built by {what} in non-compile-owning "
                    f"module '{ctx.relpath}' — specializes on raw Python "
                    f"shapes, bypassing engine/bucketing.py and the "
                    f"PlanCache; route through Engine/backend build() "
                    f"instead"))
        return out

    def _check_cache_keys(self, ctx: ModuleContext) -> list[Finding]:
        out = []
        # function-local (and module-level) Name -> assigned value, for
        # resolving `key = (...); cache.get_or_build(key, ...)`
        assigns: dict[str, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns[node.targets[0].id] = node.value
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get_or_build" and node.args):
                continue
            key = node.args[0]
            if isinstance(key, ast.Name) and key.id in assigns:
                key = assigns[key.id]
            how = _stringified(key)
            if how:
                out.append(self.finding(
                    ctx, node.args[0],
                    f"plan-cache key built with {how} — stringified keys "
                    f"collapse distinct statics (or embed per-object reprs) "
                    f"and defeat bucket reuse; use a structured tuple key"))
        return out
