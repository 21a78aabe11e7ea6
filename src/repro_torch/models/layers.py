"""Shared neural layers: norms, RoPE, MLPs, embeddings.

The counterpart of ``repro.models.layers``, function for function: the
norms and the rotary tables work in float32 and return the input's dtype;
RoPE is the split-halves form; the GELU is the tanh approximation
(``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, beinsum

__all__ = ["apply_rope", "embed", "embedding_specs", "gelu_mlp",
           "gelu_mlp_specs", "layer_norm", "layernorm_specs", "rms_norm",
           "rmsnorm_specs", "rope_frequencies", "swiglu", "swiglu_specs",
           "unembed"]


# ---------------------------------------------------------------- norms ----
def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rms_norm(params, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def layer_norm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ----------------------------------------------------------------- RoPE ----
def rope_frequencies(head_dim: int, positions: torch.Tensor,
                     theta: float = 10000.0):
    """(..., S) positions -> (..., S, head_dim/2) float32 cos/sin tables."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(theta, exponent)            # (hd/2,)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- MLPs ----
def swiglu_specs(d: int, ff: int) -> dict:
    return {"gate": ParamSpec((d, ff), ("embed", "ff")),
            "up": ParamSpec((d, ff), ("embed", "ff")),
            "down": ParamSpec((ff, d), ("ff", "embed"))}


def swiglu(params, x):
    g = beinsum("bsd,df->bsf", x, params["gate"])
    u = beinsum("bsd,df->bsf", x, params["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return beinsum("bsf,fd->bsd", h, params["down"])


def gelu_mlp_specs(d: int, ff: int, bias: bool = True) -> dict:
    s = {"up": ParamSpec((d, ff), ("embed", "ff")),
         "down": ParamSpec((ff, d), ("ff", "embed"))}
    if bias:
        s["up_b"] = ParamSpec((ff,), ("ff",), init="zeros")
        s["down_b"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def gelu_mlp(params, x):
    h = beinsum("bsd,df->bsf", x, params["up"])
    if "up_b" in params:
        h = h + params["up_b"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = beinsum("bsf,fd->bsd", h, params["down"])
    if "down_b" in params:
        y = y + params["down_b"]
    return y


# ----------------------------------------------------------- embeddings ----
def embedding_specs(vocab_padded: int, d: int) -> dict:
    return {"table": ParamSpec((vocab_padded, d), ("vocab", "embed"),
                               scale=1.0)}


def embed(params, tokens):
    table = params["table"]
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor):
        return _sharded_embed(table, tokens)
    return table[tokens.long()]


def _sharded_embed(table, tokens):
    """The lookup of a DTensor table (V, d), its vocab sharded where the
    rules put it: each rank looks up the tokens in its own vocab slice and
    gives zeros for the rest, a partial sum over the vocab's mesh
    dimension (the gradient of its slice then stays on the rank).  The
    tokens keep their batch sharding."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.parallel.compat import shard_map
    mesh, vocab = table.device_mesh, table.shape[0]
    tab = [Shard(0) if p == Shard(0) else Replicate()
           for p in table.placements]
    tok_pl = (tokens.placements if isinstance(tokens, DTensor)
              else [Replicate()] * mesh.ndim)
    rows = [Shard(0) if p == Shard(0) and t != Shard(0) else Replicate()
            for p, t in zip(tok_pl, tab)]
    out = [Partial() if t == Shard(0) else r for t, r in zip(tab, rows)]
    # a rank's own tokens give a partial gradient of a replicated table
    grad = [Partial() if r == Shard(0) else t for t, r in zip(tab, rows)]

    def local(tl, tok):
        off = 0
        for i, t in enumerate(tab):
            if t == Shard(0):
                off = mesh.get_local_rank(i) * -(-vocab // mesh.size(i))
        n = tl.shape[0]
        rel = tok.long() - off
        hit = (rel >= 0) & (rel < n)
        got = tl[rel.clamp(0, max(n - 1, 0))]
        return torch.where(hit[..., None], got, torch.zeros_like(got))

    return shard_map(local, mesh=mesh, in_specs=(tab, rows), out_specs=out,
                     in_grad_specs=(grad, rows))(table, tokens)


def unembed(params, x):
    """Logits over the (padded) vocab; callers mask padded ids in the loss."""
    return torch.einsum("bsd,vd->bsv", x, params["table"])
