"""Mixture-of-Experts with sort-based capacity dispatch.

The counterpart of ``repro.models.moe``: top-k softmax routing in float32
with renormalised gates, padded experts masked to -1e30 before the
softmax (Qwen2-MoE's 60 routed experts padded to 64), token -> expert
entries sorted by expert id (stable), each entry's position within its
expert's run, and tokens scattered into a dense (E, C, d) buffer; entries
past an expert's capacity C are dropped and their combine weight zeroed.
The expert FFNs are one batched product over the expert axis; shared
experts (Qwen2-MoE) and the parallel dense branch (Arctic) are added by
the caller.

Dispatch is shard-local, as the reference's: under active mesh rules
whose ``batch`` maps to data axes of total size dp (``_data_shards()``),
and with the T tokens divisible by dp, every data shard sorts only its
own T / dp tokens, scatters them into its own capacity slice of the
(E, dp, C, d) buffer (C from T / dp tokens) and drops its own overflow;
with no rules dp is 1.  Which tokens are kept therefore depends on dp,
and the result matches the reference's at the same dp.  On a plain
tensor the dp shards are rows of one batched sort; on a DTensor (the
sharded train step) each rank routes and dispatches its own tokens in a
per-shard map, the buffer moves expert-major over the data axes (the
reference's all-to-all boundary, ``shard_hint`` at its three places),
the expert products run on the rank's experts and ff slice, and each
rank combines its own tokens.

"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, beinsum
from repro_torch.parallel.api import shard_hint

__all__ = ["capacity", "moe_apply", "moe_dispatch", "moe_route",
           "moe_specs", "shared_expert_apply", "shared_expert_specs"]


def moe_specs(d: int, ff: int, n_experts_padded: int) -> dict:
    e = n_experts_padded
    return {
        "router": ParamSpec((d, e), ("embed", None), scale=0.02,
                            dtype=torch.float32),
        "gate": ParamSpec((e, d, ff), ("expert", "embed", "ff")),
        "up": ParamSpec((e, d, ff), ("expert", "embed", "ff")),
        "down": ParamSpec((e, ff, d), ("expert", "ff", "embed")),
    }


@contextlib.contextmanager
def _exact_float32(device: torch.device):
    """float32 products without TF32 on the card, so routing there sums
    as the CPU does (the reference's router is a float32 leaf)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def capacity(t: int, top_k: int, n_experts_padded: int,
             capacity_factor: float) -> int:
    """Slots per expert: the reference's float floor division, literally."""
    return int(max(8, -(-t * top_k * capacity_factor // n_experts_padded)))


def moe_route(params, xt, *, n_experts: int, top_k: int):
    """float32 routing of tokens xt (T, d): (gates (T, k) float32,
    renormalised; expert ids (T, k) int64).

    ``jax.lax.top_k`` returns tied values lowest index first, and
    ``torch.topk`` promises no order for ties; a stable descending sort
    keeps tied experts in index order, so its first k columns are the
    reference's choice, ties included.
    """
    e = params["router"].shape[1]
    with _exact_float32(xt.device):
        logits = torch.einsum("td,de->te", xt.float(), params["router"])
    if n_experts < e:                   # mask padded experts
        logits[:, n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = vals[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, expert_idx


def moe_dispatch(expert_idx, n_experts_padded: int, cap: int):
    """Sort-based dispatch of expert ids, (T, k) for one shard or (dp,
    T / dp, k) for dp shards, each shard on its own.

    Returns (order, slot, keep), each (T * k,) for one shard or (dp,
    T / dp * k): ``order`` the stable sort of a shard's entries by expert,
    ``slot`` each sorted entry's row ``e * cap + pos`` of the shard's
    flattened (E, cap) buffer (``E * cap`` when dropped) and ``keep``
    whether it fits its expert's capacity.
    """
    e = n_experts_padded
    rows = expert_idx.reshape(-1, expert_idx.shape[-2] * expert_idx.shape[-1]
                              ) if expert_idx.dim() == 3 else \
        expert_idx.reshape(1, -1)
    order = torch.argsort(rows, dim=1, stable=True)
    sorted_e = torch.gather(rows, 1, order)
    # first index of each expert's run within the shard's row
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        - run_start
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, e * cap))
    if expert_idx.dim() != 3:
        return order[0], slot[0], keep[0]
    return order, slot, keep


def _data_shards() -> int:
    """Data-parallel shard count from the active mesh rules (1 when
    unset): the reference's ``_data_shards``."""
    from repro_torch.parallel.api import active_rules
    from repro_torch.parallel.compat import axis_sizes
    rules = active_rules()
    if rules is None:
        return 1
    ax = rules.mapping.get("batch")
    if not ax:
        return 1
    sizes = axis_sizes(rules.mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return int(n)


def _dispatch(params, xt, dp: int, *, n_experts: int, top_k: int,
              capacity_factor: float):
    """Route tokens xt (T, d) and dispatch them in dp shards of T / dp.
    Returns (buf (E, dp, cap, d), gates, order, slot, keep), the last
    three (dp, T / dp * k)."""
    t, d = xt.shape
    e = params["router"].shape[1]
    t_loc = t // dp
    gates, expert_idx = moe_route(params, xt, n_experts=n_experts,
                                  top_k=top_k)
    cap = capacity(t_loc, top_k, e, capacity_factor)
    order, slot, keep = moe_dispatch(expert_idx.reshape(dp, t_loc, top_k),
                                     e, cap)
    shard = torch.arange(dp, device=xt.device)[:, None]
    gathered = xt.reshape(dp, t_loc, d)[shard, order // top_k]  # (dp, L, d)
    # dropped entries land in the spare last row, which is cut off
    buf = torch.zeros((dp, e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[shard, slot] = gathered
    buf = buf[:, :-1].reshape(dp, e, cap, d).transpose(0, 1)
    return buf, gates, order, slot, keep


def _experts(params, buf, dtype):
    """The expert FFNs (SwiGLU) over the (E, dp, cap, d) buffer, one
    batched product over experts, with the reference's hints."""
    # the "all-to-all" boundary: shard-major -> expert-major
    buf = shard_hint(buf, "expert", "batch", None, "embed")
    h = (F.silu(beinsum("escd,edf->escf", buf, params["gate"]).float()
                ).to(dtype)
         * beinsum("escd,edf->escf", buf, params["up"]))
    del buf          # GBs at Arctic's width: free it before the last product
    out_buf = beinsum("escf,efd->escd", h, params["down"])
    return shard_hint(out_buf, "expert", "batch", None, "embed")


def _combine(out_rows, gates, order, slot, keep, top_k: int):
    """Each shard's kept expert outputs back to its tokens, weighted by
    their gates: out_rows (dp, E * cap, d) -> (T, d)."""
    dp, rows, d = out_rows.shape
    shard = torch.arange(dp, device=out_rows.device)[:, None]
    picked = out_rows[shard, slot.clamp_max(rows - 1)]
    picked = torch.where(keep[..., None], picked, torch.zeros_like(picked))
    unsorted = torch.zeros_like(picked)
    unsorted[shard, order] = picked
    t = gates.shape[0]
    return torch.einsum("tkd,tk->td", unsorted.reshape(t, top_k, d),
                        gates.to(out_rows.dtype))


def moe_apply(params, x, *, n_experts: int, n_experts_padded: int,
              top_k: int, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (B, S, d).  The buffer, the expert products and the
    combine stay in x's dtype, as the reference's do."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_sharded(params, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor)
    b, s, d = x.shape
    t = b * s
    dp = _data_shards()
    if t % dp:
        dp = 1
    parts = list(_dispatch(params, x.reshape(t, d), dp, n_experts=n_experts,
                           top_k=top_k, capacity_factor=capacity_factor))
    # the buffer's one reference goes to _experts, which frees it early
    out_buf = _experts(params, parts.pop(0), x.dtype)
    gates, order, slot, keep = parts
    e, _, cap, _ = out_buf.shape
    out_rows = shard_hint(out_buf.transpose(0, 1).reshape(dp, e * cap, d),
                          "batch", None, "embed")
    y = _combine(out_rows, gates, order, slot, keep, top_k)
    return y.reshape(b, s, d)


def _moe_sharded(params, x, *, n_experts: int, top_k: int,
                 capacity_factor: float):
    """``moe_apply`` of a DTensor x (B, S, d), its batch sharded over the
    data axes: each rank routes, dispatches and combines its own tokens
    (one shard each), and the buffer between is a DTensor (E, dp, cap, d)
    over those axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.compat import shard_map
    mesh = x.device_mesh
    b, s, d = x.shape
    data = [p == Shard(0) for p in x.placements]
    rep = [Replicate()] * mesh.ndim
    by_row = [Shard(0) if dd else Replicate() for dd in data]
    by_col = [Shard(1) if dd else Replicate() for dd in data]
    dp = 1
    for i, dd in enumerate(data):
        dp *= mesh.size(i) if dd else 1

    def dispatch_local(xl, router):
        bl = xl.shape[0]
        return _dispatch({"router": router}, xl.reshape(bl * s, d), 1,
                         n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor)

    # the router's gradient from a rank's own tokens is a partial sum
    part = [Partial() if dd else Replicate() for dd in data]
    parts = list(shard_map(
        dispatch_local, mesh=mesh, in_specs=(by_row, rep),
        out_specs=(by_col, by_row, by_row, by_row, by_row),
        in_grad_specs=(by_row, part))(x, params["router"]))
    out_buf = _experts(params, parts.pop(0), x.dtype)
    gates, order, slot, keep = parts
    e, _, cap, _ = out_buf.shape
    out_rows = shard_hint(out_buf.transpose(0, 1).reshape(dp, e * cap, d),
                          "batch", None, "embed")

    def combine_local(rows, gl, ol, sl, kl):
        y = _combine(rows, gl, ol, sl, kl, top_k)
        return y.reshape(-1, s, d)

    return shard_map(combine_local, mesh=mesh,
                     in_specs=(by_row, by_row, by_row, by_row, by_row),
                     out_specs=by_row)(out_rows, gates, order, slot, keep)


# ------------------------------------------------- shared experts (Qwen) ---
def shared_expert_specs(d: int, ff_shared: int) -> dict:
    return {
        "gate": ParamSpec((d, ff_shared), ("embed", "ff")),
        "up": ParamSpec((d, ff_shared), ("embed", "ff")),
        "down": ParamSpec((ff_shared, d), ("ff", "embed")),
        "gate_proj": ParamSpec((d, 1), ("embed", None), dtype=torch.float32),
    }


def shared_expert_apply(params, x):
    g = beinsum("bsd,df->bsf", x, params["gate"])
    u = beinsum("bsd,df->bsf", x, params["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = beinsum("bsf,fd->bsd", h, params["down"])
    with _exact_float32(x.device):
        gate = torch.sigmoid(torch.einsum("bsd,do->bso", x.float(),
                                          params["gate_proj"]))
    return y * gate.to(x.dtype)
