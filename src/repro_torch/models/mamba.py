"""Mamba (selective SSM) block, the Jamba hybrid's sequence mixer.

The counterpart of ``repro.models.mamba``.  The full-sequence path runs
the scan chunk by chunk (``chunk`` steps at a time, the hidden state
carried across chunks); decode is the O(1) recurrence
h' = exp(dt * A) h + dt * B x.

Within a chunk the reference calls ``lax.associative_scan`` with the
combine (p, q) -> (p0 q0, q0 p1 + q1).  PyTorch has no such scan, so the
port runs the same combine as a log-step (Hillis-Steele) doubling over the
chunk axis: after the step at offset o every position holds the combine
of the 2o positions ending there (6 steps at chunk 64).  It multiplies
decays and never divides by their running product, which underflows in
float32.

The causal conv's tail is bf16 whatever the activations' dtype, as the
reference stores it (so decode rounds the conv input to bf16).  Nothing
here is a Pallas kernel in the reference, so the port is plain PyTorch on
the card too.

On a mesh (DTensor activations and parameters) the projections are
DTensor products, and the selective scan (prefill's chunk loop, decode's
one step) runs on each rank's own batch rows and ``d_inner`` slice as
plain tensors (``_on_shards``): the recurrence is independent per
channel, B and C are whole on every rank, so no rank needs another's
state, and the chunk loop's thousands of small ops stay off DTensor's
dispatch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, beinsum

__all__ = ["MambaState", "mamba_decode", "mamba_init_state",
           "mamba_prefill", "mamba_specs", "mamba_train"]


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, d_inner, d_state) float32 SSM state
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) bf16 causal-conv tail


def mamba_specs(d: int, d_inner: int, d_state: int, d_conv: int,
                dt_rank: int) -> dict:
    return {
        "in_proj": ParamSpec((d, 2 * d_inner), ("embed", "ff")),
        "conv_w": ParamSpec((d_conv, d_inner), (None, "ff"), scale=0.1),
        "conv_b": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * d_state), ("ff", None)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "ff")),
        "dt_bias": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "a_log": ParamSpec((d_inner, d_state), ("ff", None), init="ones"),
        "d_skip": ParamSpec((d_inner,), ("ff",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("ff", "embed")),
    }


def _causal_conv(params, x, tail=None):
    """Depthwise causal conv1d via shift-adds.  x: (B, S, d_inner)."""
    d_conv = params["conv_w"].shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    y = sum(params["conv_w"][j] * xp[:, j:j + x.shape[1]]
            for j in range(d_conv))
    new_tail = xp[:, -(d_conv - 1):] if d_conv > 1 else tail
    return y + params["conv_b"], new_tail


def _ssm_inputs(params, x_conv, d_state, dt_rank):
    """Project conv output to (dt, B, C) selective-scan inputs."""
    proj = torch.einsum("bsi,io->bso", x_conv, params["x_proj"])
    dt_r, b_mat, c_mat = torch.split(proj, [dt_rank, d_state, d_state],
                                     dim=-1)
    dt = F.softplus(
        torch.einsum("bsr,ri->bsi", dt_r, params["dt_proj"]).float()
        + params["dt_bias"].float())
    return dt, b_mat.float(), c_mat.float()


def _scan_chunk(decay, inc):
    """Inclusive scan of the combine (p, q) -> (p0 q0, q0 p1 + q1) over
    axis 1, by doubling: (running decay product, running state)."""
    n = decay.shape[1]
    off = 1
    while off < n:
        inc = torch.cat([inc[:, :off],
                         decay[:, off:] * inc[:, :-off] + inc[:, off:]],
                        dim=1)
        decay = torch.cat([decay[:, :off], decay[:, :-off] * decay[:, off:]],
                          dim=1)
        off *= 2
    return decay, inc


def _on_shards(fn, x, a_log, args, kinds, out_kinds):
    """``fn(*args)`` on plain tensors, or, for DTensor ``x``, on each
    rank's shards: ``kinds`` / ``out_kinds`` spell each tensor's dims,
    ``b`` the batch (split where ``x``'s batch is), ``f`` d_inner (split
    where ``a_log``'s is; a mesh dimension that splits both splits d_inner
    alone, the batch whole there), ``.`` whole."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.compat import shard_map
    split = ["f" if q == Shard(0) else "b" if p == Shard(0) else ""
             for p, q in zip(x.placements, a_log.placements)]

    def placements(kind):
        return [next((Shard(kind.index(c)) for c in roles if c in kind),
                     Replicate()) for roles in split]
    return shard_map(fn, mesh=x.device_mesh,
                     in_specs=tuple(placements(k) for k in kinds),
                     out_specs=tuple(placements(k) for k in out_kinds))(
        *args)


def _selective_scan(dt, b_mat, c_mat, xf, a, d_skip, *, chunk: int):
    """The chunked scan over (B, S) from a zero state: (y (B, S, di) with
    the skip term, last state (B, di, ds)); S is padded to a chunk
    multiple with dt = 0 steps (decay 1, increment 0: the state is inert
    there)."""
    b, s, d_inner = xf.shape
    s_pad = -(-s // chunk) * chunk
    if s_pad != s:
        dt, b_mat, c_mat, xf = (F.pad(v, (0, 0, 0, s_pad - s))
                                for v in (dt, b_mat, c_mat, xf))
    h = torch.zeros((b, d_inner, a.shape[1]), dtype=torch.float32,
                    device=xf.device)
    ys = []
    for c0 in range(0, s_pad, chunk):
        sl = slice(c0, c0 + chunk)
        dt_c, b_c, c_c, x_c = dt[:, sl], b_mat[:, sl], c_mat[:, sl], xf[:, sl]
        decay = torch.exp(dt_c[..., None] * a)             # (B,ck,di,ds)
        inc = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        dcum, hs = _scan_chunk(decay, inc)
        hs = hs + dcum * h[:, None]                        # fold carry in
        ys.append(torch.einsum("bcis,bcs->bci", hs, c_c))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return y + xf[:, :s] * d_skip, h


def _ssm_step(dt0, b0, c0, xf, h_prev, a, d_skip):
    """One decode step of the recurrence: (y (B, di) with the skip term,
    new state (B, di, ds))."""
    decay = torch.exp(dt0[..., None] * a)                  # (B, di, ds)
    h = decay * h_prev + (dt0 * xf)[..., None] * b0[:, None, :]
    return torch.einsum("bis,bs->bi", h, c0) + xf * d_skip, h


def mamba_train(params, x, *, d_state: int, dt_rank: int, chunk: int = 64,
                return_state: bool = False):
    """x: (B, S, d) -> (B, S, d)."""
    xz = beinsum("bsd,de->bse", x, params["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    x_conv, conv_tail = _causal_conv(params, x_in)
    x_conv = F.silu(x_conv.float()).to(x.dtype)
    dt, b_mat, c_mat = _ssm_inputs(params, x_conv, d_state, dt_rank)

    a = -torch.exp(params["a_log"].float())                # (di, ds)
    y, h = _on_shards(
        lambda *t: _selective_scan(*t, chunk=chunk), x, params["a_log"],
        (dt, b_mat, c_mat, x_conv.float(), a, params["d_skip"].float()),
        ("b.f", "b..", "b..", "b.f", "f.", "f"), ("b.f", "bf."))
    y = y * F.silu(z.float())
    out = beinsum("bsi,id->bsd", y.to(x.dtype), params["out_proj"])
    if return_state:
        return out, MambaState(h=h, conv=conv_tail.to(torch.bfloat16))
    return out


def mamba_prefill(params, x, *, d_state: int, dt_rank: int, chunk: int = 64):
    """Prefill: full-sequence output + state for subsequent decode."""
    return mamba_train(params, x, d_state=d_state, dt_rank=dt_rank,
                       chunk=chunk, return_state=True)


def mamba_init_state(params, batch: int) -> MambaState:
    d_inner = params["dt_bias"].shape[0]
    d_state = params["a_log"].shape[1]
    d_conv = params["conv_w"].shape[0]
    dev = params["dt_bias"].device
    return MambaState(
        h=torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=torch.bfloat16,
                         device=dev))


def mamba_decode(params, x, state: MambaState, *, d_state: int,
                 dt_rank: int):
    """One-token step.  x: (B, 1, d) -> (B, 1, d) + new state."""
    xz = beinsum("bsd,de->bse", x, params["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    x_conv, new_tail = _causal_conv(params, x_in.to(state.conv.dtype),
                                    tail=state.conv)
    x_conv = F.silu(x_conv.float()).to(x.dtype)
    dt, b_mat, c_mat = _ssm_inputs(params, x_conv, d_state, dt_rank)

    a = -torch.exp(params["a_log"].float())
    y, h = _on_shards(
        _ssm_step, x, params["a_log"],
        (dt[:, 0], b_mat[:, 0], c_mat[:, 0], x_conv.float()[:, 0], state.h,
         a, params["d_skip"].float()),
        ("bf", "b.", "b.", "bf", "bf.", "f.", "f"), ("bf", "bf."))
    y = y * F.silu(z.float()[:, 0])
    out = beinsum("bi,id->bd", y.to(x.dtype), params["out_proj"])
    return out[:, None], MambaState(h=h, conv=new_tail)
