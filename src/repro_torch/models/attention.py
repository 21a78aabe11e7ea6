"""GQA attention: projections, RoPE, the KV cache, prefill, decode and
cross attention, over the flash-attention kernel on the card.

The counterpart of ``repro.models.attention``, function for function.
``chunked_attention`` is the plain version of the flash-attention kernel
(``kernels/ops.py``, B5): an online softmax over KV chunks, so the
(Sq, Skv) score matrix never materialises beyond one chunk.

Where the attention runs:
  * a CUDA tensor goes through B5 (``ops.flash_attention``): training and
    prefill causal over positions 0..S-1 (the kernel counts positions from
    0, as the models' callers do), decode with ``kv_len = L + 1`` over the
    cache in place (int8 with its scales, dequantised in the kernel), the
    query at position L, cross attention non-causal; a sliding window
    goes to the kernel too.  Under grad (training, the encoder and cross
    attention included) the call is differentiable: B5 also writes each
    query row's log-sum-exp, and the backward runs B5's hand-written
    backward (B5-bwd) from it, a window included.  What B5 does not
    cover (head dims other than 64 and 128) raises ``unported``: nothing
    falls back to the plain attention on the card;
  * a CPU tensor goes through ``chunked_attention`` with the reference's
    arguments (``chunk``; decode and cross ``min(2048, Skv)``), so its
    float32 sums fold in the reference's order, every case included.

``KVCache.length`` is a host ``int``: the serving loop knows it, and a
device scalar would cost a host read per step.  Decode writes the new K/V
into the cache in place and returns it (the reference returns a new one).

On a mesh (serving under ``make_prefill_step`` / ``make_decode_step``'s
rules) the activations are DTensors and a cache's fields are DTensors on
the rules' shardings; ``_attend_on_mesh`` runs each rank's B5 call on its
own query heads and cache shard (or encoder memory) in one of the three
layouts the rules give (``parallel.rules.make_rules``):

  (a) KV heads over ``model``, batch over the data axes: the rank's
      shard is what its heads read, and nothing moves;
  (b) ``head_dim`` over ``model`` (the KV heads do not divide it): one
      all-to-all over ``model`` (``parallel.compat.exchange_dim``) makes
      the visible rows of the KV heads that the rank's query heads read
      whole on their head dims for the call, the stored cache stays
      split (the K / V projections are whole on every rank:
      ``parallel.rules.serving_param_shardings``);
  (c) ``seq_kv`` over the data axes (a batch that does not divide them):
      each rank attends over its own visible rows with ``lse``, and the
      outputs combine by it (``parallel.compat.lse_combine``); only the
      rank that owns row L writes the token's K/V.

The int8 cache and the window compose with all three; a cache write is
made in local terms (``parallel.compat.write_rows``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, beinsum
from repro_torch.models.layers import apply_rope, rope_frequencies
from repro_torch.parallel.api import shard_hint

__all__ = ["KVCache", "NEG_INF", "attention_decode", "attention_prefill",
           "attention_specs", "attention_train", "chunked_attention",
           "cross_attention", "cross_attention_specs", "mask_padded_heads",
           "new_cache", "project_memory", "quantize_kv"]

NEG_INF = -1e30
_PAD_POS = 2**30   # position of the zero keys that pad the last chunk
_KERNEL_HEAD_DIMS = (64, 128)


class KVCache(NamedTuple):
    """KV cache; optionally int8-quantised (k/v int8 + per-(token, head)
    bf16 scales).  ``length`` is a host int: the tokens in the cache."""
    k: torch.Tensor          # (B, S_max, K, hd)  bf16 or int8
    v: torch.Tensor          # (B, S_max, K, hd)
    length: int
    k_scale: torch.Tensor | None = None   # (B, S_max, K, 1) bf16 (int8)
    v_scale: torch.Tensor | None = None


def _on_card(q: torch.Tensor) -> bool:
    """True when the attention of ``q`` runs in B5: q on CUDA, or on the
    ``meta`` device, where the dry run traces the card's path (B5's
    ``meta`` path returns shapes and counts its cost); raises there for a
    head dim B5 does not cover.  False on the CPU."""
    if q.device.type not in ("cuda", "meta"):
        return False
    from repro_torch.engine.config import unported   # the engine imports us
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise unported("attention head dims other than 64 and 128 on CUDA")
    return True


def quantize_kv(x: torch.Tensor, reduce_amax=None):
    """Symmetric per-(token, head) int8: (B, S, K, hd) -> (q8, bf16 scale).

    ``reduce_amax`` (optional) takes the per-(token, head) max magnitude
    of x's head dims to the whole head's, where x holds a rank's part of
    them (an all-reduce over the ranks that split ``head_dim``), so each
    part rounds by the whole head's scale: the one-device values."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def chunked_attention(q, k, v, q_positions, kv_positions, *, causal: bool,
                      chunk: int = 512, window: int | None = None,
                      kv_valid_len=None, k_scale=None, v_scale=None):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, hd); k/v: (B, Skv, K, hd) with H = K * G; positions are
    int32 (Sq,) and (Skv,).  Returns (B, Sq, H, hd) in q's dtype.  Masks:
    causal (q_pos >= kv_pos), optional sliding window, optional
    kv_valid_len (ragged cache).  With k_scale/v_scale (int8 cache,
    (B, Skv, K, 1)), chunks are dequantised one at a time.  Scores, the
    running max and sum, and the accumulator are float32.
    """
    b, sq, h, hd = q.shape
    skv, kk = k.shape[1], k.shape[2]
    if h % kk:
        raise ValueError(f"query heads {h} not a multiple of KV heads {kk}")
    g = h // kk
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, sq, kk, g, hd).float() * scale

    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    quant = k_scale is not None
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=_PAD_POS)
        if quant:
            k_scale = F.pad(k_scale, (0, 0, 0, 0, 0, pad))
            v_scale = F.pad(v_scale, (0, 0, 0, 0, 0, pad))

    m = torch.full((b, sq, kk, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kk, g, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i, p_i = k[:, sl].float(), v[:, sl].float(), kv_positions[sl]
        if quant:
            k_i = k_i * k_scale[:, sl].float()
            v_i = v_i * v_scale[:, sl].float()
        logits = torch.einsum("bqkgh,bckh->bqkgc", qg, k_i)
        mask = (p_i < _PAD_POS)[None, :].expand(sq, chunk)
        if causal:
            mask = mask & (q_positions[:, None] >= p_i[None, :])
        if window is not None:
            mask = mask & (q_positions[:, None] - p_i[None, :] < window)
        if kv_valid_len is not None:
            mask = mask & (p_i < kv_valid_len)[None, :]
        logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p,
                                                   v_i)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention_specs(d: int, n_heads: int, n_kv: int, head_dim: int,
                    qkv_bias: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d), ("heads", "head_dim", "embed")),
    }
    if qkv_bias:
        s["bq"] = ParamSpec((n_heads, head_dim), ("heads", "head_dim"),
                            init="zeros")
        s["bk"] = ParamSpec((n_kv, head_dim), ("kv_heads", "head_dim"),
                            init="zeros")
        s["bv"] = ParamSpec((n_kv, head_dim), ("kv_heads", "head_dim"),
                            init="zeros")
    return s


def mask_padded_heads(params: dict, real_h: int | None,
                      real_k: int | None) -> dict:
    """Zero-mask padding heads (configs/base.py ``n_heads_padded``): with
    zero wq/wk/wv/wo slices they add nothing, so the model is exactly the
    logical architecture.  A no-op when nothing is padded."""
    p = dict(params)
    h = p["wq"].shape[1]
    if real_h is not None and real_h < h:
        mh = (torch.arange(h, device=p["wq"].device) < real_h).to(
            p["wq"].dtype)
        p["wq"] = p["wq"] * mh[None, :, None]
        p["wo"] = p["wo"] * mh[:, None, None]
        if "bq" in p:
            p["bq"] = p["bq"] * mh[:, None]
    k = p["wk"].shape[1]
    if real_k is not None and real_k < k:
        mk = (torch.arange(k, device=p["wk"].device) < real_k).to(
            p["wk"].dtype)
        p["wk"] = p["wk"] * mk[None, :, None]
        p["wv"] = p["wv"] * mk[None, :, None]
        if "bk" in p:
            p["bk"] = p["bk"] * mk[:, None]
            p["bv"] = p["bv"] * mk[:, None]
    return p


def _project_qkv(params, x, positions, rope_theta):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,K,hd), RoPE applied."""
    q = beinsum("bsd,dhk->bshk", x, params["wq"])
    k = beinsum("bsd,dhk->bshk", x, params["wk"])
    v = beinsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if rope_theta is not None:
        cos, sin = rope_frequencies(q.shape[-1], positions, rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _kv_index(h: int, kk: int, h0: int, hl: int, device):
    """The KV heads that query heads h0 .. h0 + hl - 1 of h read (head i
    reads KV head i // (h / kk)), as an index of the heads' dimension: a
    slice (part of one group, or whole groups), else one per query
    head."""
    g = h // kk
    if g % hl == 0:
        return slice(h0 // g, h0 // g + 1)
    if h0 % g == 0 and hl % g == 0:
        return slice(h0 // g, (h0 + hl) // g)
    return torch.arange(h0, h0 + hl, device=device) // g


def _local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's own heads of DTensors q (B, S, H, hd)
    and k / v (B, S, K, hd), and its output as a DTensor laid out as q.

    Attention is independent per batch row and head: each rank runs ``fn``
    on its local shards (B5 and B5-bwd on the card), and nothing moves
    between ranks.  Query head h reads KV head h // G (G = H / K).  When
    the rules shard the KV heads with the query heads, a rank's KV shard
    is what its query heads read.  When they leave the KV heads replicated
    (K not divisible by the mesh dimension), the rank slices out the KV
    heads its query heads read, possibly part of a group (4 query heads of
    one KV head); their gradients are then partial sums over that mesh
    dimension, as each rank's is nonzero only on its slice."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.compat import shard_map
    mesh = q.device_mesh
    h, kk = q.shape[2], k.shape[2]
    qp, kp, kg = [], [], []
    head_dim = None
    for i, p in enumerate(q.placements):
        if p == Shard(2):
            head_dim = i
            split = k.placements[i] == Shard(2) and kk % mesh.size(i) == 0
            qp.append(p)
            kp.append(Shard(2) if split else Replicate())
            kg.append(Shard(2) if split else Partial())
        else:
            keep = Shard(0) if p == Shard(0) else Replicate()
            qp.append(keep)
            kp.append(keep)
            kg.append(keep)
    slice_kv = head_dim is not None and kp[head_dim] == Replicate()

    def local(ql, kl, vl):
        # DTensor's views of these gradients need them contiguous
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if slice_kv:
            hl = ql.shape[2]
            idx = _kv_index(h, kk, mesh.get_local_rank(head_dim) * hl, hl,
                            ql.device)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl.contiguous(), vl.contiguous())

    return shard_map(local, mesh=mesh, in_specs=(qp, kp, kp), out_specs=qp,
                     in_grad_specs=(qp, kg, kg))(q, k, v)


def _self_attention(q, k, v, positions, *, causal, chunk, window):
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _local_heads(
            lambda ql, kl, vl: _self_attention(
                ql, kl, vl, positions, causal=causal, chunk=chunk,
                window=window), q, k, v)
    if _on_card(q):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return chunked_attention(q, k, v, positions, positions, causal=causal,
                             chunk=chunk, window=window)


def attention_train(params, x, positions, *, n_heads, n_kv, head_dim,
                    rope_theta=10000.0, causal=True, chunk=512,
                    window=None):
    """Full-sequence attention (training / encoder)."""
    q, k, v = _project_qkv(params, x, positions, rope_theta)
    out = _self_attention(q, k, v, positions, causal=causal, chunk=chunk,
                          window=window)
    return beinsum("bshk,hkd->bsd", out, params["wo"])


def new_cache(lead: tuple, s_max: int, n_kv: int, head_dim: int, dtype,
              device, quantize: bool = False) -> KVCache:
    """An empty (length 0) cache of zeros, (*lead, S_max, K, hd): ``lead``
    is (B,), or (n_groups, B) for a stacked one; int8 with bf16 scales when
    ``quantize``."""
    shape = (*lead, s_max, n_kv, head_dim)
    if not quantize:
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=0)
    sshape = (*lead, s_max, n_kv, 1)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device), length=0,
        k_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.bfloat16, device=device))


def attention_prefill(params, x, positions, s_max, *, rope_theta=10000.0,
                      chunk=512, window=None, quantize: bool = False,
                      cache: KVCache | None = None):
    """Causal prefill: returns (output, populated KVCache of size s_max).

    ``cache`` (optional, of size s_max, int8 iff ``quantize``) is filled in
    place instead of a new one; rows past the prompt keep what they hold
    (the reference's are zeros; no read ever reaches them).
    """
    b, s, _ = x.shape
    if s > s_max:
        raise ValueError(f"prompt of {s} tokens over a cache of {s_max}")
    q, k, v = _project_qkv(params, x, positions, rope_theta)
    # the prompt attends over its fresh K / V, never over the cache
    out = _self_attention(q, k, v, positions, causal=True, chunk=chunk,
                          window=window)
    if cache is None:
        cache = new_cache((b,), s_max, k.shape[2], k.shape[3], k.dtype,
                          x.device, quantize)
    _write_kv(cache, k, v, 0)
    return beinsum("bshk,hkd->bsd", out, params["wo"]), \
        cache._replace(length=s)


def _write_kv(cache: KVCache, k, v, row0: int) -> None:
    """K / V (B, n, K, hd) into the cache's rows row0 .. row0 + n - 1 in
    place, quantised when the cache is int8.  On a mesh (DTensor fields)
    each rank writes the rows of its own shard, in local terms."""
    from torch.distributed.tensor import DTensor
    quant = cache.k_scale is not None
    if not isinstance(cache.k, DTensor):
        n = k.shape[1]
        if quant:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            cache.k_scale[:, row0:row0 + n] = ks
            cache.v_scale[:, row0:row0 + n] = vs
        cache.k[:, row0:row0 + n] = k
        cache.v[:, row0:row0 + n] = v
        return
    from repro_torch.parallel.compat import write_rows
    mesh, pl = cache.k.device_mesh, list(cache.k.placements)
    rows = cache.k.shape[1]
    kl, vl = (_local_as(t, mesh, pl, seq_dim=1) for t in (k, v))
    dst = [(cache.k, kl), (cache.v, vl)]
    if quant:
        from repro_torch.parallel.compat import mesh_max
        hd_dims = _dims_of(pl, 3)
        whole = ((lambda amax: mesh_max(amax, mesh, hd_dims)) if hd_dims
                 else None)
        kl, ks = quantize_kv(kl, whole)
        vl, vs = quantize_kv(vl, whole)
        dst = [(cache.k, kl), (cache.v, vl), (cache.k_scale, ks),
               (cache.v_scale, vs)]
    for t, src in dst:
        write_rows(t.to_local(), src, mesh, list(t.placements), 1, row0,
                   rows)


def _attend_on_mesh(q, k, v, k_scale, v_scale, *, kv_len: int, q_pos: int,
                    causal: bool, window):
    """Attention of DTensor q (B, Sq, H, hd) over DTensors k / v (B, S, K,
    hd) (a cache, or the encoder memory), keys 0 .. kv_len - 1 visible,
    query row i at position q_pos + i; a DTensor laid out as q's heads.

    Per mesh dimension, q takes the K / V's split of the batch or of the
    heads (of the query heads when K / V split head_dim and H divides
    it), else stays whole.  Each rank then calls B5 (or its plain version
    on the CPU) on its own shards: the K / V in place in layout (a); in
    layout (b) the visible rows of the KV heads its query heads read, made
    whole on their head dims first by one all-to-all over the head_dim's
    mesh dimension (``parallel.compat.exchange_dim``: each rank sends each
    other rank its head dims of the KV heads that rank reads); in layout
    (c) over its own visible rows with ``lse``, the outputs then combined
    over the rows' mesh dimensions by ``lse`` (a rank with no visible row
    adds nothing and launches nothing).  Query heads whose KV heads lie whole on the rank read
    their slice of them, as ``_local_heads`` does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.compat import (
        exchange_dim,
        local_range,
        lse_combine,
    )
    mesh, pl = k.device_mesh, list(k.placements)
    b, sq, h, hd = q.shape
    rows, kk = k.shape[1], k.shape[2]
    qpl = []
    for i, p in enumerate(pl):
        if p in (Shard(0), Shard(2)):
            qpl.append(p)
        elif p == Shard(3) and h % mesh.size(i) == 0:
            qpl.append(Shard(2))
        else:
            qpl.append(Replicate())
    ql = _local_as(q, mesh, qpl, seq_dim=-1).contiguous()
    kl, vl = k.to_local(), v.to_local()
    ksl = None if k_scale is None else k_scale.to_local()
    vsl = None if v_scale is None else v_scale.to_local()
    lo, n_loc = local_range(mesh, pl, 1, rows)
    # the oldest key row 0 sees
    first = max(0, q_pos + 1 - window) if window is not None else 0
    a = max(first, lo) - lo                 # this rank's visible rows
    e = min(kv_len, lo + n_loc) - lo
    q_off = q_pos - lo
    hd_dims, seq_dims = _dims_of(pl, 3), _dims_of(pl, 1)
    hl = ql.shape[2]
    h0 = local_range(mesh, qpl, 2, h)[0]
    if hd_dims:       # layout (b): the visible rows, whole head dims
        (d,) = hd_dims                   # the rules split it over `model`
        a, e = max(a, 0), max(e, a)
        # the first query head of each rank of d (all alike when d leaves
        # the query heads whole)
        step = hl if qpl[d] == Shard(2) else 0
        head0 = h0 - mesh.get_local_rank(d) * step
        asks = [_kv_index(h, kk, head0 + r * step, hl, kl.device)
                for r in range(mesh.size(d))]
        kl, vl = (exchange_dim([t[:, a:e][:, :, i] for i in asks], mesh, d,
                               3) for t in (kl, vl))
        if ksl is not None:     # the scales lie whole on every rank
            own = asks[mesh.get_local_rank(d)]
            ksl, vsl = (t[:, a:e][:, :, own].contiguous()
                        for t in (ksl, vsl))
        q_off, e, a = q_off - a, e - a, 0
    elif kl.shape[2] * h != kk * hl:
        # the KV heads of this rank's query heads
        idx = _kv_index(h, kk, h0, hl, kl.device)
        kl, vl = kl[:, :, idx].contiguous(), vl[:, :, idx].contiguous()
        if ksl is not None:
            ksl = ksl[:, :, idx].contiguous()
            vsl = vsl[:, :, idx].contiguous()
    kw = dict(causal=causal, window=window, k_scale=ksl, v_scale=vsl)
    if not seq_dims:
        out = ops.flash_attention(ql, kl, vl, kv_len=e, q_offset=q_off, **kw)
    else:             # layout (c): this rank's rows, combined by lse
        if e > a:
            out, lse = ops.flash_attention_fwd(ql, kl, vl, kv_len=e,
                                               q_offset=q_off, **kw)
        else:
            out = torch.zeros_like(ql)
            lse = torch.full((ql.shape[0], ql.shape[2], sq), float("-inf"),
                             dtype=torch.float32, device=ql.device)
        out = lse_combine(out, lse, mesh, seq_dims)
    return DTensor.from_local(out, mesh, qpl, run_check=False,
                              shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def _contiguous_stride(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _dims_of(placements, dim: int) -> list:
    """The mesh dimensions that shard tensor dimension ``dim``."""
    return [i for i, p in enumerate(placements)
            if p.is_shard() and p.dim == dim]


def _local_as(t, mesh, placements, seq_dim: int):
    """This rank's shard of DTensor ``t`` laid out as ``placements`` with
    dimension ``seq_dim`` whole (a token's or a prompt's rows, written
    into a cache split on its rows): no communication when ``t`` already
    lies so (layout (a): the projections' heads and batch are the
    cache's)."""
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard() and p.dim == seq_dim else p
            for p in placements]
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local()


def attention_decode(params, x, cache: KVCache, *, rope_theta=10000.0,
                     window=None):
    """One-token decode against the (optionally int8) cache.  x: (B, 1, d).

    Writes the token's K/V at row ``cache.length`` in place and returns
    (output, the cache with length + 1).
    """
    pos_l = cache.length
    s_max = cache.k.shape[1]
    if not 0 <= pos_l < s_max:
        raise ValueError(f"cache of {s_max} rows is full at {pos_l}")
    quant = cache.k_scale is not None
    pos = torch.full((1,), pos_l, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, pos, rope_theta)
    from torch.distributed.tensor import DTensor
    if isinstance(cache.k, DTensor):
        # the rank that owns row L writes the token's K / V; then each
        # rank's B5 call on its own heads and cache shard
        _write_kv(cache, k, v, pos_l)
        out = _attend_on_mesh(q, cache.k, cache.v, cache.k_scale,
                              cache.v_scale, kv_len=pos_l + 1, q_pos=pos_l,
                              causal=True, window=window)
        y = beinsum("bshk,hkd->bsd", out, params["wo"])
        return y, cache._replace(length=pos_l + 1)
    card = _on_card(q)
    _write_kv(cache, k, v, pos_l)
    if quant:
        cache = cache._replace(
            k_scale=shard_hint(cache.k_scale, "batch", "seq_kv", "kv_heads",
                               None),
            v_scale=shard_hint(cache.v_scale, "batch", "seq_kv", "kv_heads",
                               None))
    # pin the cache's layout (the reference's hint against resharding it)
    cache = cache._replace(
        k=shard_hint(cache.k, "batch", "seq_kv", "kv_heads", "head_dim"),
        v=shard_hint(cache.v, "batch", "seq_kv", "kv_heads", "head_dim"))
    if card:
        out = ops.flash_attention(q.contiguous(), cache.k, cache.v,
                                  causal=False, kv_len=pos_l + 1,
                                  window=window, q_offset=pos_l,
                                  k_scale=cache.k_scale,
                                  v_scale=cache.v_scale)
    else:
        kv_pos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        out = chunked_attention(
            q, cache.k, cache.v, pos, kv_pos, causal=True,
            chunk=min(2048, s_max), window=window, kv_valid_len=pos_l + 1,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
    y = beinsum("bshk,hkd->bsd", out, params["wo"])
    return y, cache._replace(length=pos_l + 1)


# ------------------------------------------------------ cross-attention ----
def cross_attention_specs(d: int, n_heads: int, n_kv: int, head_dim: int):
    return attention_specs(d, n_heads, n_kv, head_dim)


def cross_attention(params, x, memory_k, memory_v,
                    memory_valid_len: int | None = None):
    """Decoder->encoder attention; memory_k/v: (B, Sm, K, hd) precomputed.
    ``memory_valid_len`` (a host int) masks memory rows at and past it."""
    q = beinsum("bsd,dhk->bshk", x, params["wq"])
    sm = memory_k.shape[1]
    from torch.distributed.tensor import DTensor
    if isinstance(memory_k, DTensor):
        out = _attend_on_mesh(q, memory_k, memory_v, None, None,
                              kv_len=sm if memory_valid_len is None
                              else memory_valid_len, q_pos=0, causal=False,
                              window=None)
    elif _on_card(q):
        out = ops.flash_attention(q.contiguous(), memory_k.contiguous(),
                                  memory_v.contiguous(), causal=False,
                                  kv_len=memory_valid_len)
    else:
        out = chunked_attention(
            q, memory_k, memory_v,
            torch.zeros((x.shape[1],), dtype=torch.int32, device=x.device),
            torch.arange(sm, dtype=torch.int32, device=x.device),
            causal=False, chunk=min(2048, sm), kv_valid_len=memory_valid_len)
    return beinsum("bshk,hkd->bsd", out, params["wo"])


def project_memory(params, memory):
    """Precompute cross-attention K/V from encoder output (B, Sm, d)."""
    k = beinsum("bsd,dhk->bshk", memory, params["wk"])
    v = beinsum("bsd,dhk->bshk", memory, params["wv"])
    return k, v
