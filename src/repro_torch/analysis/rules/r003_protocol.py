"""R003 — backend protocol conformance.

``engine/registry.py`` dispatches backends dynamically (a duck-typed
Protocol), so a drifted method name or a renamed positional argument in
one backend only fails at runtime, possibly deep inside an out-of-core
sweep.  This rule statically checks every ``@register_backend`` class in
``engine/backends/`` against the port's surface, as its callers use it
(``engine/engine.py``, ``engine/registry.py`` and the out-of-core loop
``partition/ooc.py``):

* solo quartet: ``plan_key`` / ``build`` / ``prepare`` / ``run``, plus a
  ``name`` class attribute and an explicit ``supports_batch``;
* ``supports_batch = True`` additionally requires the batched trio
  ``build_batch`` / ``prepare_batch`` / ``run_batch``;
* ``supports_partition = True`` additionally requires the partition
  hooks the out-of-core loop calls: the eight of the unfused sweep and
  the fused pair ``partition_move_fused`` / ``partition_split_fused``.
  The port has no separate fused flag: the loop calls the fused pair
  whenever the plan from ``build_partition`` says ``fuse``.

Where the port's surface differs from the JAX package's, it is the
port's: ``build``, ``build_batch``, ``build_partition`` and
``prepare_partition`` take the ``device``, and the partition hooks name
their plan ``sweeps``.  Positional parameter *names* must match exactly,
so one name means one thing across backends and a keyword call works on
every backend.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import ModuleContext, Rule, dotted_name

# method -> expected positional parameter names (after self)
_SOLO = {
    "plan_key": ["config"],
    "build": ["bucket", "config", "device"],
    "prepare": ["graph", "bucket", "config"],
    "run": ["plan", "inputs", "n_real", "init_labels", "init_active"],
}
_BATCH = {
    "build_batch": ["bucket", "config", "device"],
    "prepare_batch": ["batch", "bucket", "config"],
    "run_batch": ["plan", "inputs", "init_labels", "init_active"],
}
_PARTITION = {
    "build_partition": ["config", "device"],
    "partition_caps": ["budget", "d_bucket"],
    "partition_prepare_nbytes": ["shapes"],
    "prepare_partition": ["resident", "shapes", "config", "device"],
    "partition_move": ["sweeps", "inputs", "labels_loc", "cand_owned",
                       "seed", "bound"],
    "partition_wake": ["sweeps", "inputs", "changed_loc"],
    "partition_split": ["sweeps", "inputs", "comm_loc", "labels_loc",
                        "active_owned", "bound"],
    "partition_split_wake": ["sweeps", "inputs", "comm_loc", "changed_loc"],
    "partition_move_fused": ["sweeps", "inputs", "labels_loc", "changed_loc",
                             "active_owned", "cand_prev_owned", "klass_owned",
                             "seed", "bound"],
    "partition_split_fused": ["sweeps", "inputs", "comm_loc", "labels_loc",
                              "changed_loc", "bound"],
}


def _registered_backend(cls: ast.ClassDef) -> bool:
    for deco in cls.decorator_list:
        if isinstance(deco, ast.Call) \
                and dotted_name(deco.func) == "register_backend":
            return True
    return False


def _class_attr(cls: ast.ClassDef, attr: str):
    """(found, constant value or None) for a class-body assignment."""
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target] if isinstance(stmt.target,
                                                  ast.Name) else []
            value = stmt.value
        else:
            continue
        if any(t.id == attr for t in targets):
            if isinstance(value, ast.Constant):
                return True, value.value
            return True, None
    return False, None


def _positional_params(fn: ast.FunctionDef) -> list[str]:
    names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


class ProtocolRule(Rule):
    id = "R003"
    tag = "protocol"
    description = ("registered backends must implement the full "
                   "build/prepare/run x solo/batch/partition surface with "
                   "the port's parameter names")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith("engine/backends/")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef) and _registered_backend(cls):
                findings.extend(self._check_class(ctx, cls))
        return findings

    def _check_class(self, ctx: ModuleContext,
                     cls: ast.ClassDef) -> list[Finding]:
        out: list[Finding] = []
        methods = {stmt.name: stmt for stmt in cls.body
                   if isinstance(stmt, ast.FunctionDef)}

        has_name, _ = _class_attr(cls, "name")
        if not has_name:
            out.append(self.finding(
                ctx, cls, f"backend '{cls.name}' has no `name` class "
                f"attribute (registry reporting relies on it)"))
        has_sb, batch_val = _class_attr(cls, "supports_batch")
        if not has_sb:
            out.append(self.finding(
                ctx, cls, f"backend '{cls.name}' must declare "
                f"`supports_batch` explicitly (Engine.fit_many dispatches "
                f"on it; a missing attr reads as False by accident)"))

        required = dict(_SOLO)
        if has_sb and batch_val:
            required.update(_BATCH)
        has_sp, part_val = _class_attr(cls, "supports_partition")
        if has_sp and part_val:
            required.update(_PARTITION)

        for meth, want in required.items():
            fn = methods.get(meth)
            if fn is None:
                out.append(self.finding(
                    ctx, cls,
                    f"backend '{cls.name}' is missing `{meth}"
                    f"({', '.join(want)})` — registry dispatch fails only "
                    f"at runtime"))
                continue
            got = _positional_params(fn)
            if got != want:
                out.append(self.finding(
                    ctx, fn,
                    f"backend '{cls.name}'.{meth} positional params "
                    f"({', '.join(got)}) drift from the protocol "
                    f"({', '.join(want)}) — keyword call sites in the "
                    f"engine and the out-of-core loop will break"))
        return out
