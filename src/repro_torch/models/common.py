"""Parameter plumbing for the LM models: specs, initialisation, einsum.

The counterpart of ``repro.models.common``.  Every module exposes
``*_specs(...) -> tree of ParamSpec`` (a tree is nested ``dict``s with
string keys); parameters are made from specs (``init_from_specs``) or
stood in for on the ``meta`` device (``abstract_from_specs``).  Each
ParamSpec carries the reference's *logical* axis names; the port runs on
one card, so they only mirror the reference's trees (``logical_axes``).

Leaves are visited in sorted-key order, as ``jax.tree.flatten`` visits a
dict, so a leaf's index is the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["ParamSpec", "abstract_from_specs", "beinsum", "float32_replay",
           "init_from_specs", "leaf_paths", "logical_axes", "map_specs",
           "round_up", "set_leaf", "stack_specs"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]            # logical axis name (or None) per dim
    init: str = "normal"             # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def map_specs(fn: Callable[[ParamSpec], Any], specs):
    """``fn`` over every ParamSpec leaf; the tree's dicts are kept."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def leaf_paths(specs, prefix: tuple = ()) -> list[tuple[tuple, ParamSpec]]:
    """(path, spec) of every leaf, in ``jax.tree.flatten``'s order."""
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    out = []
    for k in sorted(specs):
        out += leaf_paths(specs[k], prefix + (k,))
    return out


def set_leaf(tree: dict, path: tuple, value) -> None:
    """``tree[path[0]]...[path[-1]] = value``, making the dicts on the
    way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_from_specs(specs, seed: int, device=None, shardings=None):
    """Materialise parameters on ``device`` (``None``: CUDA).

    Leaf ``i`` (flatten order) draws from its own ``torch.Generator`` on
    the target device, seeded with ``seed * 2**20 + i``: normal(0, 1) in
    float32 times the spec's scale, cast to its dtype.  The same seed gives
    the same weights on one device type; the CPU's and the card's
    generators differ, and neither reproduces ``jax.random`` (parity tests
    carry the reference's weights over with ``convert.params_from_numpy``).
    With ``shardings`` (a tree of ``(mesh, placements)``, e.g. a step's
    ``psh``), each rank keeps its shard of each leaf as a DTensor and
    frees the whole leaf before the next: the same values as
    ``parallel.api.shard_tree`` of the whole tree, one whole leaf at a
    time on the device.
    """
    dev = torch.device("cuda" if device is None else device)
    out: dict = {}
    for i, (path, s) in enumerate(leaf_paths(specs)):
        if s.init == "zeros":
            v = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        elif s.init == "ones":
            v = torch.ones(s.shape, dtype=s.dtype, device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed * 2**20 + i)
            v = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=dev)
            v = v.mul_(s.scale).to(s.dtype)
        if not path:
            return v
        if shardings is not None:
            from repro_torch.parallel.api import shard_tree
            sh = shardings
            for k in path:
                sh = sh[k]
            v = shard_tree(v, sh)
        set_leaf(out, path, v)
    return out


def abstract_from_specs(specs):
    """Tensors on the ``meta`` device: shapes and dtypes, no storage."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


def logical_axes(specs):
    """Tree of logical-axis tuples mirroring the param tree."""
    return map_specs(lambda s: s.axes, specs)


def stack_specs(specs, n: int, axis_name=None):
    """Prepend a stacking dimension (the reference's scan over layers)."""
    return map_specs(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes,
                                         s.init, s.scale, s.dtype), specs)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def beinsum(expr: str, *ops):
    """einsum; bf16 operands give a bf16 result.

    The reference asks XLA for bf16 partial sums when every operand is bf16
    (its tensor-parallel all-reduces then move half the bytes).  On one
    card there is no all-reduce: ``torch.einsum`` of bf16 operands sums in
    float32 inside the matrix product and rounds the result to bf16 once,
    which is what the reference's CPU path gives too.  Mixed dtypes are
    promoted first, as ``jnp.einsum`` promotes them.
    """
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(expr, *(o.to(dt) for o in ops))


# The decoder groups' sub-trees that only products read (``beinsum``, the
# bias adds, the zero-masking of padded heads)
PRODUCT_SUBTREES = ("attn", "cross", "mlp", "moe", "shared", "dense2")


def float32_replay(params: dict) -> dict:
    """The model in float32 over the same weights, in a fraction of the
    memory of a float32 copy: every leaf upcast except the decoder groups'
    attention, cross-attention, MLP and MoE sub-trees, which stay as they
    are.  Activations then start in float32 (the embeddings are), and each
    product upcasts those weights where it reads them (``beinsum``
    promotes, as ``jnp.einsum`` does), so the replay computes what the
    fully upcast tree computes, bit for bit; only the largest matrices
    never exist in float32 all at once.  Everything that meets a bf16
    activation by design (the encoder's input, Mamba's conv over its bf16
    tail) is upcast."""
    def up(tree):
        if isinstance(tree, torch.Tensor):
            return tree.float()
        return {k: up(v) for k, v in tree.items()}
    out = {k: up(v) for k, v in params.items() if k != "groups"}
    out["groups"] = {pos: {name: sub if name in PRODUCT_SUBTREES else up(sub)
                           for name, sub in layer.items()}
                     for pos, layer in params["groups"].items()}
    return out
