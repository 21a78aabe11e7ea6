"""R001 — host-sync hazard in hot-path modules.

The throughput story of the port (one kernel launch per sub-sweep, no
blocking readbacks) dies quietly when an ``int()`` / ``.item()`` /
``.cpu()`` sneaks into a sweep loop: every iteration then waits for the
stream to drain and copies a value to the host.  This rule flags, inside
the hot modules (``core/``, ``kernels/``, ``engine/backends/``,
``partition/ooc.py``):

* **compiled scopes** (functions decorated with or handed to
  ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``, the
  port's counterpart of a ``jax.jit`` scope): any concretizer applied to
  a function parameter — under compilation it is a graph break at best
  and a recompile per call at worst.  The port has no such scope today;
  the half stays so that one added later is held to the same rule;
* **host-driven sweep loops**: concretizers applied to values produced
  by sweep callables inside a ``for``/``while`` body — each one is a
  blocking sync per iteration.

Concretizers: ``int`` / ``float`` / ``bool`` of a tensor, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` / ``np.array`` of
a tensor, the port's ``to_host`` (``engine/registry.py``: a pinned copy
and one synchronize), and ``Tensor.__bool__``: a device value tested by
an ``if`` / ``while``.

Sweep callables (the seeds of the device-value analysis): the JAX
package's plan surfaces (``plan.step(...)``, ``sweeps.move(...)``, a
``make_*_step`` product), the port's kernel entry points
(``ops.label_argmax``, ``ops.fused_move``, ``ops.min_label``,
``ops.fused_split``), the backends' partition hooks
(``be.partition_move(...)`` and the rest), and the core sweeps the
host loops call directly (``lpa_move``, ``_min_label_sweep``, ...): in
the port these are what the JAX package jits.

The analysis follows each function's statements in order, so a name
rebound to a host value (``dn = int(dn_t)``) is a host value afterwards
and only the concretizer itself is reported.

Deliberate host-driven convergence checks (one scalar per iteration, or
one per-slot ``done`` vector per batched iteration) carry an inline
``# lint: host-sync-ok — <why>`` suppression.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    ModuleContext,
    Rule,
    assigned_names,
    dotted_name,
)

_HOT_PREFIXES = ("core/", "kernels/", "engine/backends/")
_HOT_FILES = ("partition/ooc.py",)

_SCALARIZERS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_HOST_COPIES = {"to_host"}

# Plan surfaces of the JAX package: receiver names holding plans and the
# per-stage method names the backends and loops dispatch through.
_PLAN_RECEIVERS = {"plan", "sweeps", "ops_ns"}
_SWEEP_METHODS = {"propagate", "split", "step", "move", "wake", "split_wake"}
_STEP_FACTORY = re.compile(r"^make_\w*step$")
# The port's kernel entry points (kernels/ops.py), called as ``ops.<name>``.
_KERNEL_OPS = {"label_argmax", "fused_move", "min_label", "fused_split"}
# The backends' partition hooks, called on any backend object.
_PARTITION_HOOKS = {"partition_move", "partition_wake", "partition_split",
                    "partition_split_wake", "partition_move_fused",
                    "partition_split_fused"}
# The core sweeps the port's host loops call directly.
_CORE_SWEEPS = {"lpa_move", "lpa_move_dense", "neighbors_of",
                "neighbors_of_dense", "_min_label_sweep", "min_label_sweep",
                "min_label_wake"}

_TRACING_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

# Metadata reads of a tensor: host values, never a sync.
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda"}
_META_CALLS = {"len", "isinstance", "dim", "numel", "size"}


def _is_compile_wrapping(call: ast.Call) -> bool:
    """Call expression that produces a compiled callable from its args:
    torch.compile(f), partial(torch.compile, ...), torch.jit.script(f)."""
    name = dotted_name(call.func)
    if name in _TRACING_CALLS:
        return True
    if name in ("partial", "functools.partial") and call.args:
        return dotted_name(call.args[0]) in _TRACING_CALLS
    return False


def sync_call(node: ast.Call) -> tuple[str, list[ast.AST]] | None:
    """(op description, value expressions) when ``node`` forces a sync."""
    func = node.func
    if isinstance(func, ast.Name) and func.id in _SCALARIZERS and node.args:
        return f"{func.id}()", [node.args[0]]
    if isinstance(func, ast.Name) and func.id in _HOST_COPIES and node.args:
        return f"{func.id}()", list(node.args)
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
        return f".{func.attr}()", [func.value]
    name = dotted_name(func)
    if name in _NP_SYNC and node.args:
        return f"{name}()", [node.args[0]]
    return None


def _outside_syncs(node: ast.AST):
    """The nodes under ``node`` that a tensor value flows through: the
    subtrees of concretizers (their results are host values), ``is``
    tests, metadata reads (``.shape``, ``len()``) and nested functions
    are left out."""
    if isinstance(node, ast.Call):
        if sync_call(node) is not None:
            return
        leaf = dotted_name(node.func)
        if leaf and leaf.rsplit(".", 1)[-1] in _META_CALLS:
            return
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return
    if isinstance(node, (ast.Lambda, ast.FunctionDef)):
        return
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _outside_syncs(child)


def value_refs(node: ast.AST) -> set[str]:
    """Names a value expression reads *as tensors* (see
    :func:`_outside_syncs`)."""
    return {n.id for n in _outside_syncs(node) if isinstance(n, ast.Name)}


def is_sweep_call(call: ast.Call, step_callables: set[str]) -> bool:
    """A call that dispatches device sweep work (see module docstring)."""
    func = call.func
    if isinstance(func, ast.Attribute):
        root = func.value
        if (func.attr in _SWEEP_METHODS and isinstance(root, ast.Name)
                and root.id in _PLAN_RECEIVERS):
            return True
        if func.attr in _PARTITION_HOOKS:
            return True
        if func.attr in _KERNEL_OPS and dotted_name(root) is not None \
                and dotted_name(root).rsplit(".", 1)[-1] == "ops":
            return True
    name = dotted_name(func)
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1]
    return leaf in _CORE_SWEEPS or name in step_callables


def step_callables(fn: ast.FunctionDef) -> set[str]:
    """Names in ``fn`` bound to ``make_*_step`` / ``torch.compile``
    products."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            made = _is_compile_wrapping(call)
            fname = dotted_name(call.func)
            if fname and _STEP_FACTORY.match(fname.rsplit(".", 1)[-1]):
                made = True
            if made:
                for t in node.targets:
                    out.update(assigned_names(t))
    return out


def all_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    return [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]


def traced_functions(tree: ast.Module) -> set[ast.FunctionDef]:
    """Functions whose bodies run under ``torch.compile`` / TorchScript:
    decorated with it (``@torch.compile``, ``@torch.compile(...)``,
    ``@torch.jit.script``) or handed to it by name."""
    by_name = {fn.name: fn for fn in all_functions(tree)}
    traced: set[ast.FunctionDef] = set()
    for fn in by_name.values():
        for deco in fn.decorator_list:
            if dotted_name(deco) in _TRACING_CALLS:
                traced.add(fn)
            elif isinstance(deco, ast.Call) and _is_compile_wrapping(deco):
                traced.add(fn)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_compile_wrapping(node):
            for arg in node.args:
                name = dotted_name(arg)
                if name in by_name:
                    traced.add(by_name[name])
    return traced


class _LoopSyncs:
    """Flow-sensitive device-value tracking over one function's body.

    Statements are followed in order; a loop body is walked twice so that
    values carried round the loop are seen; an ``if``'s branches join by
    union.  A plain name bound to a host value (a concretizer's result, a
    constant) stops being a device value; a subscript store only adds.
    """

    def __init__(self, steps: set[str]):
        self.steps = steps
        self.hits: list[tuple[ast.AST, str, str]] = []   # node, op, name

    def device_ref(self, value: ast.AST, tainted: set[str]) -> str | None:
        """What makes ``value`` a device value: a device name it reads, or
        a sweep call in it (outside any concretizer); else None."""
        hit = value_refs(value) & tainted
        if hit:
            return sorted(hit)[0]
        for sub in _outside_syncs(value):
            if isinstance(sub, ast.Call) and is_sweep_call(sub, self.steps):
                return f"{dotted_name(sub.func)}()"
        return None

    def check(self, node: ast.AST, tainted: set[str]) -> None:
        """Record the syncs on device values under ``node``."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            sync = sync_call(sub)
            if sync is None:
                continue
            op, values = sync
            for v in values:
                ref = self.device_ref(v, tainted)
                if ref is not None:
                    self.hits.append((sub, op, ref))
                    break

    def check_test(self, test: ast.expr, tainted: set[str]) -> None:
        hit = value_refs(test) & tainted
        if hit:
            self.hits.append((test, "Tensor.__bool__", sorted(hit)[0]))

    def assign(self, targets, value, tainted: set[str], aug: bool) -> None:
        dev = self.device_ref(value, tainted) is not None
        for t in targets:
            if isinstance(t, ast.Name):
                if dev:
                    tainted.add(t.id)
                elif not aug:
                    tainted.discard(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                self.assign(t.elts, value, tainted, aug)
            elif isinstance(t, ast.Starred):
                self.assign([t.value], value, tainted, aug)
            elif dev:
                # x[i] = ... / x.attr = ...: the container now holds it
                root = t
                while isinstance(root, (ast.Subscript, ast.Attribute)):
                    root = root.value
                if isinstance(root, ast.Name):
                    tainted.add(root.id)

    def block(self, stmts, tainted: set[str], in_loop: bool) -> set[str]:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.For, ast.While)):
                for _ in range(2):
                    if isinstance(st, ast.While):
                        self.check(st.test, tainted)
                        self.check_test(st.test, tainted)
                    else:
                        if in_loop:
                            self.check(st.iter, tainted)
                        self.assign([st.target], st.iter, tainted, False)
                    tainted = self.block(st.body, tainted, True)
                tainted = self.block(st.orelse, tainted, in_loop)
            elif isinstance(st, ast.If):
                if in_loop:
                    self.check(st.test, tainted)
                    self.check_test(st.test, tainted)
                a = self.block(st.body, set(tainted), in_loop)
                b = self.block(st.orelse, set(tainted), in_loop)
                tainted = a | b
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    if in_loop:
                        self.check(item.context_expr, tainted)
                tainted = self.block(st.body, tainted, in_loop)
            elif isinstance(st, ast.Try):
                tainted = self.block(st.body, tainted, in_loop)
                for h in st.handlers:
                    tainted |= self.block(h.body, set(tainted), in_loop)
                tainted = self.block(st.orelse, tainted, in_loop)
                tainted = self.block(st.finalbody, tainted, in_loop)
            else:
                if in_loop:
                    self.check(st, tainted)
                if isinstance(st, ast.Assign):
                    self.assign(st.targets, st.value, tainted, False)
                elif isinstance(st, ast.AugAssign):
                    self.assign([st.target], st.value, tainted, True)
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    self.assign([st.target], st.value, tainted, False)
        return tainted


class HostSyncRule(Rule):
    id = "R001"
    tag = "host-sync"
    description = ("device->host sync hazards (int()/.item()/.cpu()/"
                   "to_host/Tensor.__bool__ on device values) in hot-path "
                   "sweep code")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(_HOT_PREFIXES) or relpath in _HOT_FILES

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        traced = traced_functions(ctx.tree)
        for fn in all_functions(ctx.tree):
            if fn in traced:
                findings.extend(self._check_traced(ctx, fn))
            findings.extend(self._check_host_loops(ctx, fn))
        return findings

    # --- compiled scopes ---

    def _check_traced(self, ctx: ModuleContext,
                      fn: ast.FunctionDef) -> list[Finding]:
        params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                  + fn.args.kwonlyargs)}
        out = []
        for node in ast.walk(fn):
            hit, op = set(), None
            if isinstance(node, ast.Call) and sync_call(node) is not None:
                op, values = sync_call(node)
                for v in values:
                    hit |= params & value_refs(v)
            elif isinstance(node, (ast.If, ast.While)):
                op = "Tensor.__bool__"
                hit = params & value_refs(node.test)
                node = node.test
            if hit:
                out.append(self.finding(
                    ctx, node,
                    f"{op} on traced value '{sorted(hit)[0]}' inside "
                    f"compiled '{fn.name}' — a graph break, or a "
                    f"recompile per call"))
        return out

    # --- host-driven sweep loops ---

    def _check_host_loops(self, ctx: ModuleContext,
                          fn: ast.FunctionDef) -> list[Finding]:
        walker = _LoopSyncs(step_callables(fn))
        walker.block(fn.body, set(), False)
        out, seen = [], set()
        for node, op, name in walker.hits:
            loc = (node.lineno, node.col_offset)
            if loc in seen:   # loop bodies are walked twice
                continue
            seen.add(loc)
            out.append(self.finding(
                ctx, node,
                f"{op} on device value '{name}' inside a sweep loop in "
                f"'{fn.name}' — blocking device->host transfer every "
                f"iteration"))
        return out
