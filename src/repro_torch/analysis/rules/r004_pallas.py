"""R004 — kernel-launch hygiene in ``kernels/``.

The JAX package's R004 holds its ``pl.pallas_call`` sites to four checks.
The port has no Pallas: its kernels are CUDA C++ in ``kernels/csrc/``,
launched through ``kernels/ops.py``'s ``_launch``.  The rule keeps its id
and its ``pallas`` suppression tag all the same, so that a finding, a
baseline entry and a ``# lint: pallas-ok`` mean one thing in both
packages; each check maps one to one onto the launch:

* **launch guard** (the reference's grid-divisibility guard): a function
  that calls ``_launch(...)`` must check its operands before launching,
  through the shape checks (``_tiles`` / ``_check_tile`` / ``_check_vec``)
  or an ``if ...: raise`` of its own.  A CUDA kernel does not check the
  shapes it is handed: a wrong one reads out of bounds, or silently
  drops rows.
* **host ops in the launching wrapper** (the reference's host ops in the
  kernel body): the bodies are C++, which the linter does not parse; the
  host side of a launch is the wrapper, and an ``np.*`` / ``print`` /
  ``.item()`` / ``.cpu()`` / ``.tolist()`` there is a host round trip (a
  sync) per launch.
* **shared-memory footprint** (the reference's VMEM footprint): the wide
  LPA kernels hold one row per warp in shared memory, 16 bytes per slot
  of the row's power-of-two capacity (at least 32 slots): an 8-byte key,
  a 4-byte label and a 4-byte weight (``csrc/lpa_common.cuh``,
  ``wide_row`` and ``wide_launch``).  When the widest row a launch guard
  admits resolves to an int from module constants (``d > MAX_DEGREE``),
  one warp's row of that width must fit under a ceiling: by default the
  H100's 227 KB of opt-in shared memory per block.  A symbolic bound is
  skipped.
* **equality-cube budget**: a function that materialises the
  (rows, D, D) equality cube (``lab[:, :, None] == lab[:, None, :]``)
  allocates D*D per row; it must bound the cube against a budget before
  building it (``assert rows * d * d * 4 <= CUBE_BUDGET_BYTES``, or the
  same as an ``if ...: raise``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    ModuleContext,
    Rule,
    _const_int,
    dotted_name,
    function_map,
    module_int_constants,
)

_DEFAULT_SMEM_CEILING = 227 * 1024   # H100 opt-in shared memory per block
_SMEM_BYTES_PER_SLOT = 16            # lpa_common.cuh: key 8 + label 4 + w 4
_MIN_ROW_SLOTS = 32                  # lpa_common.cuh wide_cap: one warp

_LAUNCH = "_launch"
_SHAPE_CHECKS = {"_tiles", "_check_tile", "_check_vec"}
_HOST_ROOTS = {"np", "numpy"}
_HOST_METHODS = {"item", "tolist", "cpu"}


def _calls(fn: ast.FunctionDef, names: set[str]) -> list[ast.Call]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None and name.split(".")[-1] in names:
                out.append(node)
    return out


def _raising_ifs(fn: ast.FunctionDef) -> list[ast.If]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.If)
            and any(isinstance(b, ast.Raise) for b in n.body)]


def _has_launch_guard(fn: ast.FunctionDef) -> bool:
    return bool(_calls(fn, _SHAPE_CHECKS) or _raising_ifs(fn)
                or any(isinstance(n, ast.Assert) for n in ast.walk(fn)))


def _helpers(fn: ast.FunctionDef, by_name: dict[str, ast.FunctionDef],
             seen: set[str] | None = None) -> list[ast.FunctionDef]:
    """``fn`` and the module-local functions it calls, transitively."""
    seen = set() if seen is None else seen
    if fn.name in seen:
        return []
    seen.add(fn.name)
    out = [fn]
    for call in _calls(fn, set(by_name)):
        local = by_name.get(dotted_name(call.func).split(".")[-1])
        if local is not None:
            out.extend(_helpers(local, by_name, seen))
    return out


def _width_bound(fns: list[ast.FunctionDef],
                 env: dict[str, int]) -> int | None:
    """The widest row an ``if <x> > C: raise`` guard admits, C resolved
    from int literals and module constants; None when there is none."""
    bounds = []
    for fn in fns:
        for node in _raising_ifs(fn):
            for cmp in ast.walk(node.test):
                if not (isinstance(cmp, ast.Compare) and len(cmp.ops) == 1):
                    continue
                op, left, right = cmp.ops[0], cmp.left, cmp.comparators[0]
                if isinstance(op, (ast.Gt, ast.GtE)):
                    c = _const_int(right, env)
                    if c is not None and _const_int(left, env) is None:
                        bounds.append(c if isinstance(op, ast.Gt) else c - 1)
                elif isinstance(op, (ast.Lt, ast.LtE)):
                    c = _const_int(left, env)
                    if c is not None and _const_int(right, env) is None:
                        bounds.append(c if isinstance(op, ast.Lt) else c - 1)
    return min(bounds) if bounds else None


def row_smem_bytes(width: int) -> int:
    """Shared memory of one warp's wide row of ``width`` slots."""
    cap = _MIN_ROW_SLOTS
    while cap < width:
        cap <<= 1
    return cap * _SMEM_BYTES_PER_SLOT


def _is_rank3_broadcast(node: ast.expr) -> bool:
    """``x[:, :, None]``-style subscript: >=3-elt slice tuple with None."""
    if not isinstance(node, ast.Subscript) \
            or not isinstance(node.slice, ast.Tuple) \
            or len(node.slice.elts) < 3:
        return False
    return any(isinstance(e, ast.Constant) and e.value is None
               for e in node.slice.elts)


def _cube_sites(fn: ast.FunctionDef,
                owner: dict[int, ast.FunctionDef]) -> list[ast.Compare]:
    """Equality-cube compares whose innermost function is ``fn``."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and owner.get(id(node)) is fn:
            sides = [node.left, *node.comparators]
            if sum(_is_rank3_broadcast(s) for s in sides) >= 2:
                out.append(node)
    return out


def _has_cube_budget(fn: ast.FunctionDef) -> bool:
    """An assert or ``if ...: raise`` bounding a product: a ``*`` and an
    order compare (the ``rows * d * d * 4 <= BUDGET`` shape)."""
    tests = [n.test for n in ast.walk(fn) if isinstance(n, ast.Assert)]
    tests += [n.test for n in _raising_ifs(fn)]
    for test in tests:
        sub = list(ast.walk(test))
        has_mult = any(isinstance(s, ast.BinOp)
                       and isinstance(s.op, ast.Mult) for s in sub)
        has_bound = any(isinstance(s, ast.Compare) and any(
            isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
            for op in s.ops) for s in sub)
        if has_mult and has_bound:
            return True
    return False


class PallasRule(Rule):
    id = "R004"
    tag = "pallas"
    description = ("kernel-launch hygiene: launch guard, no host ops in "
                   "launching wrappers, shared-memory row footprint "
                   "ceiling, equality-cube budget")

    def __init__(self, smem_ceiling: int = _DEFAULT_SMEM_CEILING):
        self.smem_ceiling = int(smem_ceiling)

    def applies(self, relpath: str) -> bool:
        return relpath.startswith("kernels/")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        owner = function_map(ctx.tree)
        consts = module_int_constants(ctx.tree)
        by_name = {n.name: n for n in ast.walk(ctx.tree)
                   if isinstance(n, ast.FunctionDef)}

        for fn in by_name.values():
            for site in _cube_sites(fn, owner):
                if not _has_cube_budget(fn):
                    findings.append(self.finding(
                        ctx, site,
                        f"'{fn.name}' materialises the (rows, D, D) "
                        f"equality cube with no budget bound (`assert "
                        f"rows * d * d * 4 <= CUBE_BUDGET_BYTES` or an "
                        f"if-raise) — its memory grows as D^2 per row"))

            launches = [c for c in _calls(fn, {_LAUNCH})
                        if owner.get(id(c)) is fn]
            if not launches or fn.name == _LAUNCH:
                continue
            site = launches[0]
            if not _has_launch_guard(fn):
                findings.append(self.finding(
                    ctx, site,
                    f"kernel launch in '{fn.name}' without a launch guard "
                    f"(_tiles/_check_tile/_check_vec or an if-raise) — a "
                    f"CUDA kernel trusts its shapes: a wrong one reads out "
                    f"of bounds or drops rows"))
            findings.extend(self._check_host_ops(ctx, fn))
            width = _width_bound(_helpers(fn, by_name), consts)
            if width is not None and row_smem_bytes(width) > self.smem_ceiling:
                findings.append(self.finding(
                    ctx, site,
                    f"'{fn.name}' admits rows of {width} slots: one warp's "
                    f"row needs ~{row_smem_bytes(width) // 1024} KiB of "
                    f"shared memory, over the ceiling "
                    f"({self.smem_ceiling // 1024} KiB) — lower the width "
                    f"bound or raise --smem-ceiling with a justification"))
        return findings

    def _check_host_ops(self, ctx: ModuleContext,
                        fn: ast.FunctionDef) -> list[Finding]:
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            bad = None
            if name and name.split(".")[0] in _HOST_ROOTS:
                bad = f"{name}()"
            elif isinstance(node.func, ast.Name) and node.func.id == "print":
                bad = "print()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_METHODS:
                bad = f".{node.func.attr}()"
            if bad:
                out.append(self.finding(
                    ctx, node,
                    f"host op {bad} in '{fn.name}', which launches a "
                    f"kernel — a host round trip on every launch"))
        return out
