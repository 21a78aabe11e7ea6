"""GQA attention: the chunked online-softmax oracle and int8 KV quantisation.

The counterpart of ``repro.models.attention``'s ``chunked_attention`` and
``quantize_kv``, held to them on the same inputs.  ``chunked_attention`` is
the plain version of the flash-attention kernel (``kernels/ops.py``): an
online softmax over KV chunks, so the (Sq, Skv) score matrix never
materialises beyond one chunk.  The projections, rotary embedding, KV cache
and decode path are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "chunked_attention", "quantize_kv"]

NEG_INF = -1e30
_PAD_POS = 2**30   # position of the zero keys that pad the last chunk


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(token, head) int8: (B, S, K, hd) -> (q8, bf16 scale)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
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
