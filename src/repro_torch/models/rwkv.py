"""RWKV6 "Finch" block: attention-free time mix with data-dependent decay.

The counterpart of ``repro.models.rwkv``: the per-channel, per-token decay
``w_t = exp(-exp(w0 + tanh(x W_a) W_b))``, static token-shift
interpolation, and the WKV recurrence over a per-head (hd x hd) float32
state.  The reference scans the recurrence over time with ``lax.scan``;
the port loops over the tokens in Python, one state update per token.
Nothing here is a Pallas kernel in the reference, so the port is plain
PyTorch on the card too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, beinsum

__all__ = ["RwkvState", "rwkv_channel_mix", "rwkv_channel_specs",
           "rwkv_time_mix", "rwkv_time_specs"]


class RwkvState(NamedTuple):
    wkv: torch.Tensor      # (B, H, hd, hd) float32
    shift_t: torch.Tensor  # (B, d) last token input (time mix)
    shift_c: torch.Tensor  # (B, d) last token input (channel mix)


def rwkv_time_specs(d: int, n_heads: int, lora_r: int = 64) -> dict:
    hd = d // n_heads
    return {
        "mu_r": ParamSpec((d,), ("embed",), scale=0.5),
        "mu_k": ParamSpec((d,), ("embed",), scale=0.5),
        "mu_v": ParamSpec((d,), ("embed",), scale=0.5),
        "mu_g": ParamSpec((d,), ("embed",), scale=0.5),
        "mu_w": ParamSpec((d,), ("embed",), scale=0.5),
        "wr": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wo": ParamSpec((n_heads, hd, d), ("heads", "head_dim", "embed")),
        # data-dependent decay (the Finch contribution)
        "w0": ParamSpec((d,), ("embed",), init="zeros"),
        "w_a": ParamSpec((d, lora_r), ("embed", None)),
        "w_b": ParamSpec((lora_r, d), (None, "embed")),
        "bonus_u": ParamSpec((n_heads, hd), ("heads", "head_dim"),
                             scale=0.5),
        "ln_scale": ParamSpec((d,), ("embed",), init="ones"),
    }


def rwkv_channel_specs(d: int, ff: int) -> dict:
    return {
        "mu_k": ParamSpec((d,), ("embed",), scale=0.5),
        "mu_r": ParamSpec((d,), ("embed",), scale=0.5),
        "wk": ParamSpec((d, ff), ("embed", "ff")),
        "wr": ParamSpec((d, d), ("embed", None)),
        "wv": ParamSpec((ff, d), ("ff", "embed")),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / the carried ``last`` at t = 0)."""
    if last is None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    dt = torch.promote_types(last.dtype, x.dtype)   # jnp.concatenate's
    return torch.cat([last[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _decay(params, xw):
    """w_t in (0, 1): exp(-exp(w0 + tanh(xw W_a) W_b))."""
    lora = torch.einsum("bsr,rd->bsd",
                        torch.tanh(torch.einsum("bsd,dr->bsr", xw.float(),
                                                params["w_a"].float())),
                        params["w_b"].float())
    return torch.exp(-torch.exp(params["w0"].float() + lora))


class _MetaScan(torch.autograd.Function):
    """``_wkv_scan``'s shape-only stand-in on the ``meta`` device (the dry
    run, ``launch/dryrun.py``): the token loop would take its tracer tens
    of minutes a layer at 32k tokens.  It returns the scan's outputs, keeps
    one (B, H, hd, hd) float32 state a token for the backward (what the
    loop's autograd holds, roughly), and adds the loop's products to the
    cost table: one (hd) x (hd, hd) product a token and head forward, two
    backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, wkv):
        from repro_torch.parallel.compat import add_product_flops
        b, s, h, hd = r.shape
        ctx.flops = 2 * b * s * h * hd * hd
        add_product_flops(ctx.flops)
        ctx.save_for_backward(torch.empty((s, b, h, hd, hd),
                                          dtype=torch.float32, device="meta"))
        ctx.inputs = [None if t is None else (t.shape, t.dtype)
                      for t in (r, k, v, w, u, wkv)]
        return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                torch.empty((b, h, hd, hd), dtype=torch.float32,
                            device="meta"))

    @staticmethod
    def backward(ctx, d_out, d_wkv):
        from repro_torch.parallel.compat import add_product_flops
        add_product_flops(2 * ctx.flops)
        return tuple(None if x is None else
                     torch.empty(x[0], dtype=x[1], device="meta")
                     for x in ctx.inputs)


def _wkv_scan(r, k, v, w, u, wkv):
    """The WKV recurrence over the sequence, token by token, from ``wkv``
    (B, H, hd, hd; None: zeros): (out (B, S, H, hd), the last state).  On
    ``meta``, ``_MetaScan``."""
    if r.is_meta:
        return _MetaScan.apply(r, k, v, w, u, wkv)
    b, s, h, hd = r.shape
    if wkv is None:
        wkv = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], wkv + u * kv))
        wkv = w[:, t, :, :, None] * wkv + kv
    return torch.stack(outs, dim=1), wkv


def _scan_on_shards(r, k, v, w, u, wkv):
    """``_wkv_scan`` on plain tensors, or, for DTensor ``r``, on each
    rank's shards: a mesh dimension that splits r's batch or heads splits
    every input's (the state's too), any other takes them whole, so the
    loop's per-token operations run on local tensors."""
    from torch.distributed.tensor import DTensor
    if not isinstance(r, DTensor):
        return _wkv_scan(r, k, v, w, u, wkv)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.compat import shard_map
    roles = ["b" if p == Shard(0) else "h" if p == Shard(2) else ""
             for p in r.placements]

    def layout(**dims):
        return [Shard(dims[c]) if c in dims else Replicate() for c in roles]
    seq, state = layout(b=0, h=2), layout(b=0, h=1)
    return shard_map(_wkv_scan, mesh=r.device_mesh,
                     in_specs=(seq, seq, seq, seq, layout(h=1),
                               None if wkv is None else state),
                     out_specs=(seq, state))(r, k, v, w, u, wkv)


def rwkv_time_mix(params, x, state: RwkvState | None = None,
                  n_heads: int = 32):
    """x: (B, S, d).  Returns (out, (wkv state, x[:, -1]))."""
    b, s, d = x.shape
    hd = d // n_heads
    last = None if state is None else state.shift_t
    xs = _shift(x, last)
    xr = _mix(x, xs, params["mu_r"])
    xk = _mix(x, xs, params["mu_k"])
    xv = _mix(x, xs, params["mu_v"])
    xg = _mix(x, xs, params["mu_g"])
    xw = _mix(x, xs, params["mu_w"])

    r = beinsum("bsd,dhk->bshk", xr, params["wr"]).float()
    k = beinsum("bsd,dhk->bshk", xk, params["wk"]).float()
    v = beinsum("bsd,dhk->bshk", xv, params["wv"]).float()
    g = beinsum("bsd,dhk->bshk", xg, params["wg"])
    w = _decay(params, xw).reshape(b, s, n_heads, hd)      # (B,S,H,hd)
    u = params["bonus_u"].float()[None, :, :, None]        # (1,H,hd,1)

    out, wkv = _scan_on_shards(r, k, v, w, u,
                               None if state is None else state.wkv)

    # group norm per head (population variance) + gate
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, s, d) * params["ln_scale"].float()
    out = out.reshape(b, s, n_heads, hd)
    out = (out * F.silu(g.float())).to(x.dtype)
    y = beinsum("bshk,hkd->bsd", out, params["wo"])
    return y, (wkv, x[:, -1])


def rwkv_channel_mix(params, x, last=None):
    """x: (B, S, d).  Returns (out, x[:, -1])."""
    xs = _shift(x, last)
    xk = _mix(x, xs, params["mu_k"])
    xr = _mix(x, xs, params["mu_r"])
    k = beinsum("bsd,df->bsf", xk, params["wk"])
    k = torch.square(F.relu(k.float())).to(x.dtype)
    r = torch.sigmoid(
        torch.einsum("bsd,de->bse", xr, params["wr"]).float())
    return (r.to(x.dtype) * beinsum("bsf,fd->bsd", k, params["wv"]),
            x[:, -1])
