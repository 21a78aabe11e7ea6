"""AdamW with dtype-configurable state and global-norm clipping, over
parameter trees (nested dicts of tensors).

The port of ``repro.optim.adamw``, operation for operation: the clip
factor ``min(1, clip_norm / max(gnorm, 1e-12))``, float32 bias
corrections, and ``p - lr * (step + wd * p)`` in float32, cast back to
each parameter's dtype.  ``torch.optim.AdamW`` rounds otherwise and has no
global clip.  Leaves are visited in sorted-key order, as
``jax.tree.flatten`` visits a dict, so ``global_norm`` sums in the
reference's order.

``adamw_update(..., in_place=True)`` (the train step's ``donate``) writes
the new parameters and moments into the given tensors leaf by leaf, so an
update holds one leaf's float32 temporaries at a time beside the state
instead of a second copy of it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor       # 0-d int32, the updates made


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            out = {k: rec(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return next(it)
    return rec(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the dicts are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf (a 0-d tensor).

    DTensor leaves (the sharded train step's gradients) give the norm of
    the whole gradient, the same on every rank: each rank sums the squares
    of its own shard of each leaf (a replicated shard counted on one rank
    only), one all-reduce of that (n_leaves,) vector over the mesh's
    ranks adds them up, and the leaves are folded in order, as the
    one-device norm folds them."""
    leaves = tree_leaves(tree)
    if not any(_is_dtensor(x) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves))
    return torch.sqrt(sum(_sharded_squares(leaves).unbind()))


def _sharded_squares(leaves) -> torch.Tensor:
    """(n_leaves,) float32: each DTensor leaf's sum of squares over every
    rank of its mesh, reduced together (the leaves sharded or replicated,
    none partial)."""
    import torch.distributed as dist
    mesh = next(x for x in leaves if _is_dtensor(x)).device_mesh
    parts = []
    for x in leaves:
        owner = all(mesh.get_local_rank(i) == 0
                    for i, p in enumerate(x.placements) if not p.is_shard())
        sq = torch.sum(torch.square(x.to_local().to(torch.float32)))
        parts.append(sq if owner else torch.zeros_like(sq))
    vec = torch.stack(parts)
    dist.all_reduce(vec)       # a DeviceMesh spans the world: every rank
    return vec


def _update_leaf(g, m, v, p, scale, b1c, b2c, lr, b1, b2, eps,
                 weight_decay):
    """(p_new, m_new, v_new), float32: the reference's operations in its
    order, each rounded to float32 as there (a product's operands may be
    swapped, a sum's too: both are exact), written in place into
    temporaries where that saves a pass."""
    gf = g.to(torch.float32) * scale
    m_new = m.to(torch.float32) * b1
    m_new += gf * (1.0 - b1)                    # b1 m + (1 - b1) g
    v_new = v.to(torch.float32) * b2
    v_new += gf.square_().mul_(1.0 - b2)        # b2 v + (1 - b2) g^2
    del gf
    denom = (v_new / b2c).sqrt_().add_(eps)
    step = (m_new / b1c).div_(denom)
    del denom
    p32 = p.to(torch.float32)
    upd = (p32 * weight_decay).add_(step).mul_(lr)   # lr (step + wd p)
    return p32 - upd, m_new, v_new


def adamw_update(grads, state: AdamWState, params, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 in_place: bool = False):
    """Returns (new_params, new_state, {"grad_norm"}).  ``lr`` is a host
    float or a 0-d float32 tensor.  With ``in_place`` the parameter and
    moment tensors are overwritten and returned (the count too).

    DTensor leaves (the sharded train step's ZeRO-1 state) are updated on
    each rank's shard: the gradient and the moments share one layout, the
    parameter is taken onto it (the rank's own slice, no traffic), the
    update runs on the local tensors, and the new parameter goes back to
    its own layout (the all-gather)."""
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          clip_norm / torch.maximum(
                              gnorm, torch.full_like(gnorm, 1e-12)))
    count = _local(state.count) + 1
    b1c = 1.0 - torch.pow(b1, count.to(torch.float32))
    b2c = 1.0 - torch.pow(b2, count.to(torch.float32))
    if isinstance(lr, torch.Tensor):
        lr = lr.to(gnorm.device)

    def upd(g, m, v, p):
        sharded = _is_dtensor(g)
        p_g = _redistribute(p, g.placements) if sharded else p
        p_new, m_new, v_new = _update_leaf(
            _local(g), _local(m), _local(v), _local(p_g), scale, b1c, b2c,
            lr, b1, b2, eps, weight_decay)
        if sharded:
            p_new = _redistribute(_like(g, p_new.to(p.dtype)), p.placements)
        if not in_place:
            return (p_new.to(p.dtype), _like(m, m_new.to(m.dtype)),
                    _like(v, v_new.to(v.dtype)))
        _local(p).copy_(_local(p_new))
        _local(m).copy_(m_new)
        _local(v).copy_(v_new)
        return p, m, v

    out = tree_map(upd, grads, state.m, state.v, params)
    if in_place:
        _local(state.count).copy_(count)
        count = state.count
    else:
        count = _like(state.count, count)
    return _pick(out, 0), AdamWState(m=_pick(out, 1), v=_pick(out, 2),
                                     count=count), {"grad_norm": gnorm}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x):
    """A DTensor's local shard, or ``x`` itself."""
    return x.to_local() if _is_dtensor(x) else x


def _like(ref, local):
    """``local`` laid out as ``ref`` when that is a DTensor (its global
    shape taken from ``ref``), else ``local`` itself."""
    if not _is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, list(ref.placements),
                              shape=ref.shape, stride=ref.stride())


def _redistribute(x, placements):
    """DTensor ``x`` on ``placements`` of its mesh (itself when it is
    there already)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, list(placements))


def _pick(tree, i):
    """Element ``i`` of every (p, m, v) leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
