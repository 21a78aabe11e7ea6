"""Plain PyTorch versions of the four LPA kernels (bit-exact semantics).

Each takes the same arguments as its kernel in ``ops.py``: the padded
neighbor tiles ``nbr`` (rows, D) int32, ``nmask`` (rows, D) bool and, for
the argmax, ``nw`` (rows, D) float32, plus per-vertex vectors (``labels``,
``comm``, ``chg``) that are gathered through ``nbr`` here, as the kernels
gather them on the card.  ``labels[:rows]`` is each row's own label.

The CPU path of every op runs these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import torch

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
