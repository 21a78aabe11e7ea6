"""Logical-axis sharding hints usable from plain model code.

The port's ``repro.parallel.api``.  Model code calls
``shard_hint(x, "batch", None, "embed")`` with *logical* axis names; the
active :class:`MeshRules` (installed by the step builders in
``repro_torch.train``) translates them to a physical layout.  With no
rules installed, or on a plain tensor, the hint returns ``x`` itself, so
model code runs unchanged on one device.

A physical spec is a tuple with one entry per tensor dimension: a mesh
axis name, a tuple of several, or None (replicated), trailing Nones
dropped (as the reference's ``PartitionSpec`` spells it).  On a ``DeviceMesh`` it becomes
``torch.distributed.tensor`` placements: mesh dimension ``a`` is
``Shard(i)`` when tensor dimension ``i`` names ``a``, else
``Replicate()``.  A dimension over several axes is split over them in
the order of the mesh's dimensions.

:func:`shard_tree` places a tree of whole tensors on a tree of
shardings (DTensors, no collective) and :func:`gather_tree` makes a
tree's DTensors whole again; the step builders (``train.steps``) and
the sharded init (``models.common.init_from_specs``) use them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

from repro_torch.parallel.compat import axis_names, axis_sizes

__all__ = ["MeshRules", "Sharding", "active_rules", "gather_tree",
           "normalize_spec", "placements", "shard_hint", "shard_tree",
           "use_rules"]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mesh_rules",
                                                         default=None)


def placements(mesh, spec: tuple) -> list:
    """``torch.distributed.tensor`` placements of physical ``spec`` on
    ``mesh``, one per mesh dimension.

    On a mesh of one rank every placement is ``Replicate()``: a shard
    over it holds the whole tensor, and DTensor refuses views that merge
    or drop a dimension it shards, even one of size 1 (a global batch of
    one)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh).values()
    if all(n == 1 for n in sizes):
        return [Replicate()] * len(sizes)
    out = []
    for name in axis_names(mesh):
        dim = next((i for i, s in enumerate(spec)
                    if s == name or (isinstance(s, tuple) and name in s)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def normalize_spec(spec) -> tuple:
    """``spec`` as ``PartitionSpec`` spells it: an entry of one axis is
    that axis's name, trailing Nones are dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class Sharding(tuple):
    """``(mesh, placements)``, the pair ``checkpoint.manager.restore(
    shardings=)`` takes, with the physical ``spec`` it came from."""

    def __new__(cls, mesh, spec: tuple):
        out = super().__new__(cls, (mesh, placements(mesh, spec)))
        out.spec = tuple(spec)
        return out

    @property
    def mesh(self):
        return self[0]

    @property
    def placements(self) -> list:
        return self[1]

    def __reduce__(self):
        return Sharding, (self[0], self.spec)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical -> physical axis mapping."""
    mesh: object
    mapping: dict

    def spec(self, logical: tuple) -> tuple:
        phys = []
        used: set = set()
        for ax in logical:
            m = self.mapping.get(ax) if ax is not None else None
            # an axis may be claimed at most once per spec
            if m is None or (isinstance(m, str) and m in used) or (
                    isinstance(m, tuple) and any(a in used for a in m)):
                phys.append(None)
            else:
                phys.append(m)
                used.update(m if isinstance(m, tuple) else (m,))
        return normalize_spec(phys)

    def sharding(self, logical: tuple) -> Sharding:
        return Sharding(self.mesh, self.spec(tuple(logical)))


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rules() -> MeshRules | None:
    return _ACTIVE.get()


def shard_hint(x, *logical):
    """``x`` laid out as the active rules place ``logical``: a DTensor is
    redistributed (a layout, never a change of value); anything else, or
    no active rules, returns ``x``."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, pl = rules.sharding(tuple(logical))
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def shard_tree(tree, shardings):
    """Tensors that every rank holds in full as DTensors of their
    shardings: each rank keeps a copy of its own part (the full tensor can
    then be freed, and is never written), with no collective.  A None
    sharding leaves its tensor as it is.  Works on dicts and on named
    tuples (an ``AdamWState``, caches; a host int stays).  A ``meta``
    tensor stays on ``meta`` (the dry run's shapes)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(shard_tree(t, s)
                            for t, s in zip(tree, shardings)))
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], shardings[k]) for k in tree}
    if shardings is None or not isinstance(tree, torch.Tensor):
        return tree
    mesh, pl = shardings
    src = tree if tree.is_meta else tree.to(mesh.device_type)
    dt = distribute_tensor(src, mesh, list(pl), src_data_rank=None)
    return DTensor.from_local(dt.to_local().clone(), mesh, list(pl),
                              shape=dt.shape, stride=dt.stride())


def gather_tree(tree):
    """DTensor leaves as the full tensors (``full_tensor()``, a collective
    on every rank); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(gather_tree(t) for t in tree))
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
