"""R005 — ledger discipline for edge-scale allocations.

The out-of-core path holds a hard resident-byte budget via
``partition/slices.py``'s ``MemoryLedger``; its guarantee ("we never
materialize more than ``memory_budget`` bytes of slice data") only holds
if every edge-scale allocation in the partition machinery is accounted.
This rule flags allocations in ``partition/`` and ``engine/backends/``
— ``np.zeros/empty/full/ones/concatenate/repeat/arange`` and their torch
counterparts ``torch.zeros/empty/full/ones/cat/repeat_interleave/
arange`` — whose size expression references edge-scale names (``m``,
``m_pad``, ``m_w``, ``.num_edges``; the port's own names are the same)
from functions that show no accounting evidence — no ``nbytes``
computation, no ``ledger`` mention, no ``.acquire(`` / ``.reserve(``
call.

Vertex-scale allocations (``n``, ``n_loc``) are deliberately out of
scope: the semi-external model keeps all vertex-length state resident by
design; only edge arrays are budgeted.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    ModuleContext,
    Rule,
    dotted_name,
    function_map,
)

_NP_ALLOC = {"zeros", "empty", "full", "ones", "concatenate", "repeat",
             "arange"}
_TORCH_ALLOC = {"zeros", "empty", "full", "ones", "cat", "repeat_interleave",
                "arange"}
_ROOTS = {"np": _NP_ALLOC, "numpy": _NP_ALLOC, "torch": _TORCH_ALLOC}
_EDGE_NAMES = {"m", "m_pad", "m_w"}
_EDGE_ATTRS = {"m", "m_pad", "m_w", "num_edges"}


def _is_alloc(node: ast.Call) -> str | None:
    name = dotted_name(node.func)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] in _ROOTS.get(parts[0], ()):
        return name
    return None


def _edge_scale_ref(node: ast.AST) -> str | None:
    """An edge-scale size reference under the allocation's size arg."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _EDGE_NAMES:
            return sub.id
        if isinstance(sub, ast.Attribute) and sub.attr in _EDGE_ATTRS:
            base = dotted_name(sub)
            return base if base else f".{sub.attr}"
    return None


def _has_accounting(fn: ast.FunctionDef | None) -> bool:
    """Does the enclosing function show ledger/accounting evidence?"""
    if fn is None:
        return False
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and "nbytes" in node.id:
            return True
        if isinstance(node, ast.Attribute) \
                and ("nbytes" in node.attr or "ledger" in node.attr):
            return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("acquire", "reserve"):
            return True
        if isinstance(node, ast.FunctionDef) and "nbytes" in node.name:
            return True
    return False


class LedgerRule(Rule):
    id = "R005"
    tag = "ledger"
    description = ("edge-scale numpy / torch allocations in partition code "
                   "must be accounted through MemoryLedger")

    def applies(self, relpath: str) -> bool:
        return (relpath.startswith("partition/")
                or relpath.startswith("engine/backends/"))

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        owner = function_map(ctx.tree)
        accounted: dict[int, bool] = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            alloc = _is_alloc(node)
            if alloc is None or not node.args:
                continue
            ref = _edge_scale_ref(node.args[0])
            if ref is None:
                continue
            fn = owner.get(id(node))
            key = id(fn) if fn is not None else 0
            if key not in accounted:
                accounted[key] = _has_accounting(fn)
            if accounted[key]:
                continue
            where = f"'{fn.name}'" if fn else "module scope"
            findings.append(self.finding(
                ctx, node,
                f"{alloc}() sized by edge-scale '{ref}' in {where} with no "
                f"MemoryLedger accounting (no nbytes/acquire in scope) — "
                f"unbudgeted edge arrays break the resident-byte guarantee"))
        return findings
