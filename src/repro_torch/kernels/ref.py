"""Plain PyTorch versions of the kernels in ``ops.py``.

The four LPA kernels (bit-exact semantics) take the padded neighbor tiles
``nbr`` (rows, D) int32, ``nmask`` (rows, D) bool and, for the argmax,
``nw`` (rows, D) float32, plus per-vertex vectors (``labels``, ``comm``,
``chg``) that are gathered through ``nbr`` here, as the kernels gather
them on the card.  ``labels[:rows]`` is each row's own label.

``flash_attention_ref`` is the chunked online-softmax oracle of
``models/attention.py`` at positions ``arange``;
``attention_lse_ref`` its per-row log-sum-exp and
``flash_attention_bwd_ref`` its gradient through autograd, in float32.
``flash_decode_ref`` is B5's decode body (one query row a head) in
float32: the visible keys cut by ``decode_split`` as the kernel cuts
them, each span's partial softmax, the spans combined in order.

The CPU path of every op runs these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# the module, not the name: models.attention launches B5 through ops.py,
# which imports this module
from repro_torch.models import attention as _attention

SENTINEL = 2147483647  # INT32_MAX: "no label"
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def label_hash(labels: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic per-iteration label priority (Knuth multiplicative mix).

    uint32 arithmetic emulated in int64 masked to 32 bits; returns the
    non-negative int32 ``hash & 0x7FFFFFFF``.
    """
    x = _mul32(labels.long() & _M32, 2654435761)
    x = x ^ (((int(seed) & _M32) * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    return (x & 0x7FFFFFFF).to(torch.int32)


def label_argmax_ref(nbr, nw, nmask, labels, seed: int):
    """Per row: (best_label, best_weight, current_weight).

    best_weight is the largest summed weight of one label over the real
    slots (clamped at 0); best_label among labels reaching it with weight
    > 0 has the largest ``label_hash(label, seed)``, then the smallest
    value (SENTINEL when the row has none); current_weight is the summed
    weight of slots carrying the row's own label.
    """
    rows = nbr.shape[0]
    lab = labels[nbr]
    cur = labels[:rows]
    w = torch.where(nmask, nw, 0.0)
    eq = (lab[:, :, None] == lab[:, None, :]).to(w.dtype)
    scores = torch.bmm(w[:, None, :], eq)[:, 0, :]
    scores = torch.where(nmask, scores, -1.0)

    best_w = scores.amax(dim=1, keepdim=True)
    is_best = nmask & (scores >= best_w) & (best_w > 0)
    h = label_hash(lab, seed)
    best_h = torch.where(is_best, h, -1).amax(dim=1, keepdim=True)
    pick = is_best & (h == best_h)
    best_lab = torch.where(pick, lab, SENTINEL).amin(dim=1)

    cur_w = torch.where(lab == cur[:, None], w, 0.0).sum(dim=1)
    return best_lab.to(torch.int32), best_w[:, 0].clamp_min(0.0), cur_w



def label_argmax_slot_order(nbr, nw, nmask, labels, seed: int):
    """``label_argmax_ref`` with every label's sum folded in slot order
    from 0.0, one float32 elementwise add per slot.

    That is the CUDA kernels' order, so on real weights their outputs must
    equal these bits (``label_argmax_ref`` sums through a matmul, whose
    order is its own); on integer weights the two agree exactly.
    """
    rows, d = nbr.shape
    lab = torch.where(nmask, labels[nbr.long()], SENTINEL)
    w = torch.where(nmask, nw, 0.0)
    cur = labels[:rows]
    scores = torch.zeros_like(w)
    cur_w = torch.zeros(rows, dtype=torch.float32, device=nbr.device)
    for j in range(d):
        scores += torch.where(lab == lab[:, j:j + 1], w[:, j:j + 1], 0.0)
        cur_w += torch.where(lab[:, j] == cur, w[:, j], 0.0)
    ok = lab != SENTINEL
    scores = torch.where(ok, scores, -1.0)
    best_w = scores.amax(dim=1, keepdim=True)
    is_best = ok & (scores >= best_w) & (best_w > 0)
    h = label_hash(lab, seed)
    best_h = torch.where(is_best, h, -1).amax(dim=1, keepdim=True)
    best_lab = torch.where(is_best & (h == best_h), lab, SENTINEL).amin(dim=1)
    return best_lab.to(torch.int32), best_w[:, 0].clamp_min(0.0), cur_w

def min_label_ref(nbr, nmask, labels, comm):
    """Per row: ``min(label, min{labels[v] : v a real neighbor with
    comm[v] == comm[row]})``."""
    rows = nbr.shape[0]
    ok = nmask & (comm[nbr] == comm[:rows, None])
    cand = torch.where(ok, labels[nbr], SENTINEL)
    return torch.minimum(labels[:rows], cand.amin(dim=1)).to(torch.int32)


def fused_move_ref(nbr, nw, nmask, labels, chg, active, cand_prev, klass,
                   real, seed: int):
    """Lazy wake + argmax + adopt: returns (new_labels, active_out).

    ``chg`` is the previous sub-sweep's changed mask and ``cand_prev`` its
    candidate set; the float sums are those of ``label_argmax_ref``.
    """
    rows = nbr.shape[0]
    wake = (chg[nbr] & nmask).any(dim=1)
    act = (active & ~cand_prev) | (wake & real)
    cand = act & klass
    best_lab, best_w, cur_w = label_argmax_ref(nbr, nw, nmask, labels, seed)
    adopt = cand & (best_w > cur_w.clamp_min(0.0))
    return torch.where(adopt, best_lab, labels[:rows]), act


def fused_split_ref(nbr, nmask, labels, comm, chg, prune: bool):
    """Lazy split-wake + min-label.  Without ``prune`` it is
    ``min_label_ref`` and ``chg`` is not read."""
    mres = min_label_ref(nbr, nmask, labels, comm)
    if not prune:
        return mres
    rows = nbr.shape[0]
    same = nmask & (comm[nbr] == comm[:rows, None])
    wake = (chg[nbr] & same).any(dim=1)
    return torch.where(wake, mres, labels[:rows])


def flash_attention_ref(q, k, v, causal: bool, kv_len: int | None = None,
                        window: int | None = None, q_offset: int = 0,
                        k_scale=None, v_scale=None):
    """Attention of q (B, Sq, H, hd) over k/v (B, Skv, K, hd), keys at
    positions 0.., query row i at ``q_offset + i``: ``chunked_attention``
    in chunks of ``min(512, Skv)``, returned in q's dtype.  ``kv_len``
    masks the keys at and past it (``chunked_attention``'s
    ``kv_valid_len``), ``window`` the keys ``window`` or more positions
    before a query; int8 k / v are dequantised by ``k_scale`` /
    ``v_scale`` chunk by chunk."""
    pos_q = torch.arange(q.shape[1], dtype=torch.int32,
                         device=q.device) + q_offset
    pos_k = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return _attention.chunked_attention(q, k, v, pos_q, pos_k,
                                        causal=causal,
                                        chunk=min(512, k.shape[1]),
                                        window=window, kv_valid_len=kv_len,
                                        k_scale=k_scale, v_scale=v_scale)


def attention_lse_ref(q, k, causal: bool, kv_len: int | None = None,
                      window: int | None = None, q_offset: int = 0,
                      k_scale=None):
    """Each query row's log-sum-exp of its scaled, masked scores (B, H,
    Sq) float32, under ``flash_attention_ref``'s masks (-inf for a row
    that sees no key): the statistics B5 writes for its backward and for
    a sequence-parallel decode's combine."""
    b, sq, h, hd = q.shape
    kk = k.shape[2]
    kf = k.float() if k_scale is None else k.float() * k_scale.float()
    qg = q.reshape(b, sq, kk, h // kk, hd).float() * (1.0 / (hd ** 0.5))
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, kf)
    pos_q = torch.arange(sq, device=q.device)[:, None] + q_offset
    pos_k = torch.arange(k.shape[1], device=q.device)[None, :]
    hide = pos_k >= (k.shape[1] if kv_len is None else kv_len)
    if causal:
        hide = hide | (pos_q < pos_k)
    if window is not None:
        hide = hide | (pos_q - pos_k >= window)
    s = s.masked_fill(hide, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def flash_attention_bwd_ref(q, k, v, do, causal: bool,
                            window: int | None = None):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v, causal,
    window=window)`` for the output gradient ``do``: autograd through the
    float32 oracle (the function the reference's XLA differentiates),
    each cast to its input's dtype."""
    with torch.enable_grad():
        q32, k32, v32 = (x.detach().float().requires_grad_(True)
                         for x in (q, k, v))
        out = flash_attention_ref(q32, k32, v32, causal, window=window)
        dq, dk, dv = torch.autograd.grad(out, (q32, k32, v32), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# B5's decode body (csrc/flash_attention_decode.cu): keys per tile (kBK),
# query rows per block (kRows; a CPU test holds both to the source), and
# the blocks a call aims for, two per SM of a 132-SM H100: a constant, so
# the split, and the bits, never depend on the device.
DECODE_TILE = 64
DECODE_ROWS = 16
DECODE_BLOCKS = 264


class DecodeSplit(NamedTuple):
    """The visible keys [lo, hi] of a decode call, their tiles [tile0,
    tile0 + n_tiles) of ``DECODE_TILE`` keys, and the spans: ``splits``
    runs of ``per_split`` tiles from tile0, the last cut at the end."""
    lo: int
    hi: int
    tile0: int
    n_tiles: int
    splits: int
    per_split: int

    def spans(self) -> list[tuple[int, int]]:
        """Each span's keys [start, end): whole tiles."""
        t = DECODE_TILE
        end = (self.tile0 + self.n_tiles) * t
        return [((self.tile0 + i * self.per_split) * t,
                 min((self.tile0 + (i + 1) * self.per_split) * t, end))
                for i in range(self.splits)]


@functools.lru_cache(maxsize=256)
def decode_split(b: int, h: int, kk: int, kv_len: int, causal: bool,
                 window: int | None, q_offset: int) -> DecodeSplit:
    """How B5's decode body cuts the visible keys of one query row at key
    position ``q_offset`` (keys at or past ``kv_len`` masked, after
    ``q_offset`` under ``causal``, ``window`` or more before it under a
    window): into spans of whole tiles, one block each per (batch, KV
    head, row chunk of ``DECODE_ROWS`` query heads), as many as make
    about ``DECODE_BLOCKS`` blocks, no span empty.  From the shape alone:
    ``ops`` launches with it and ``flash_decode_ref`` combines by it.
    Cached: a decode step makes the same call once a layer."""
    hi = min(q_offset, kv_len - 1) if causal else kv_len - 1
    lo = max(q_offset - window + 1, 0) if window else 0
    if lo > hi:
        raise ValueError(f"the query at {q_offset} sees no key under "
                         f"kv_len {kv_len} and window {window}")
    tile0 = lo // DECODE_TILE
    n = hi // DECODE_TILE + 1 - tile0
    chunks = -(-(h // kk) // DECODE_ROWS)
    per = -(-n // min(n, -(-DECODE_BLOCKS // (b * kk * chunks))))
    return DecodeSplit(lo, hi, tile0, n, -(-n // per), per)


def flash_decode_ref(q, k, v, causal: bool, kv_len: int | None = None,
                     window: int | None = None, q_offset: int = 0,
                     k_scale=None, v_scale=None):
    """B5's decode body for q (B, 1, H, hd) over k / v (B, Skv, K, hd) (int8
    with ``k_scale`` / ``v_scale`` (B, Skv, K, 1)), the masks of
    ``flash_attention_ref``: (out in q's dtype, lse (B, H, 1) float32).

    In float32: the visible keys cut by ``decode_split``; per span and
    query head the raw maximum m, l = sum exp(scale (s - m)) and acc =
    sum exp(scale (s - m)) v; the spans combined in order 0 .. S - 1 by
    their weights exp(scale (m - M)) (a span that sees no key weighs 0,
    as in ``parallel.compat.lse_merge``); out = acc / max(l, 1e-30) and
    lse = M scale + log(max(l, 1e-30))."""
    b, sq, h, hd = q.shape
    kk = k.shape[2]
    if sq != 1:
        raise ValueError(f"the decode body takes one query row, got {sq}")
    kv_len = k.shape[1] if kv_len is None else kv_len
    split = decode_split(b, h, kk, kv_len, causal, window, q_offset)
    kf = k.float() if k_scale is None else k.float() * k_scale.float()
    vf = v.float() if v_scale is None else v.float() * v_scale.float()
    qg = q.float().reshape(b, kk, h // kk, hd)
    scale = 1.0 / (hd ** 0.5)
    none = torch.full((b, kk, h // kk), float("-inf"), device=q.device)
    m_all = none
    parts = []
    for start, end in split.spans():
        a, e = max(start, split.lo), min(end, split.hi + 1)
        if e <= a:      # a span that sees no key
            parts.append((none, torch.zeros_like(none),
                          torch.zeros_like(qg)))
            continue
        s = torch.einsum("bkgd,bckd->bkgc", qg, kf[:, a:e])
        m = s.amax(-1)
        p = torch.exp(scale * (s - m[..., None]))
        parts.append((m, p.sum(-1), torch.einsum("bkgc,bckd->bkgd", p,
                                                 vf[:, a:e])))
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(none)
    acc = torch.zeros_like(qg)
    for m, l, part in parts:
        w = torch.where(m == float("-inf"), 0.0,
                        torch.exp(scale * (m - m_all)))
        l_all = l_all + l * w
        acc = acc + part * w[..., None]
    den = l_all.clamp_min(1e-30)
    out = (acc / den[..., None]).reshape(b, 1, h, hd).to(q.dtype)
    return out, (m_all * scale + torch.log(den)).reshape(b, h, 1)
