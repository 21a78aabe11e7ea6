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

The reference sorts per data shard (``_data_shards()``, from its mesh
rules).  The port runs on one card, where that count is 1: one shard
holds every token, and the capacity is the reference's at ``dp = 1``.

Nothing here is a Pallas kernel in the reference (XLA's sort, scatter and
einsums), so the port is plain PyTorch on the card too: ``torch.sort``,
index writes and cuBLAS products.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, beinsum

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
    """Sort-based dispatch of (T, k) expert ids over one shard.

    Returns (order, slot, keep): ``order`` the stable sort of the T * k
    entries by expert, ``slot`` each sorted entry's row ``e * cap + pos``
    of the flattened (E, cap) buffer (``E * cap`` when dropped) and
    ``keep`` whether it fits its expert's capacity.
    """
    e = n_experts_padded
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # first index of each expert's run
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - run_start
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return order, slot, keep


def moe_apply(params, x, *, n_experts: int, n_experts_padded: int,
              top_k: int, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (B, S, d).  The buffer, the expert products and the
    combine stay in x's dtype, as the reference's do."""
    b, s, d = x.shape
    t = b * s
    e = n_experts_padded
    xt = x.reshape(t, d)
    gates, expert_idx = moe_route(params, xt, n_experts=n_experts,
                                  top_k=top_k)
    cap = capacity(t, top_k, e, capacity_factor)
    order, slot, keep = moe_dispatch(expert_idx, e, cap)

    gathered = xt[order // top_k]                          # (T*k, d)
    # dropped entries land in the spare last row, which is cut off
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = gathered
    buf = buf[:-1].reshape(e, cap, d)

    # ---- expert FFNs (SwiGLU), one batched product over experts ----
    h = (F.silu(beinsum("ecd,edf->ecf", buf, params["gate"]).float()
                ).to(x.dtype)
         * beinsum("ecd,edf->ecf", buf, params["up"]))
    del buf          # GBs at Arctic's width: free it before the last product
    out_rows = beinsum("ecf,efd->ecd", h, params["down"]).reshape(e * cap, d)

    # ---- combine ----
    picked = out_rows[slot.clamp_max(e * cap - 1)]
    picked = torch.where(keep[:, None], picked, torch.zeros_like(picked))
    unsorted = torch.zeros_like(picked)
    unsorted[order] = picked
    y = torch.einsum("tkd,tk->td", unsorted.reshape(t, top_k, d),
                     gates.to(x.dtype))
    return y.reshape(b, s, d)


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
