"""Partition-quality metrics: NMI and ARI against a ground truth.

Scores recovered communities against planted partitions, beside
modularity (which needs no ground truth).  Host numpy, run once per
experiment; the same arithmetic as the JAX package's ``core/metrics.py``,
so both give the same floats.
"""
from __future__ import annotations

import numpy as np

__all__ = ["adjusted_rand_index", "normalized_mutual_info"]


def _contingency(a, b) -> np.ndarray:
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"labelings differ in length: {a.shape} vs "
                         f"{b.shape}")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    m = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.int64)
    np.add.at(m, (ai, bi), 1)
    return m


def normalized_mutual_info(a, b) -> float:
    """NMI with arithmetic-mean normalisation, in [0, 1]."""
    m = _contingency(a, b)
    n = m.sum()
    pa = m.sum(1) / n
    pb = m.sum(0) / n
    pab = m / n
    with np.errstate(divide="ignore", invalid="ignore"):
        mi = np.nansum(pab * (np.log(pab)
                              - np.log(pa[:, None] * pb[None, :])))
        ha = -np.nansum(np.where(pa > 0, pa * np.log(pa), 0.0))
        hb = -np.nansum(np.where(pb > 0, pb * np.log(pb), 0.0))
    denom = 0.5 * (ha + hb)
    return float(mi / denom) if denom > 1e-12 else 1.0


def _pairs(x):
    return x * (x - 1) / 2.0


def adjusted_rand_index(a, b) -> float:
    """ARI: chance-corrected, 1 for identical partitions, ~0 for random
    ones."""
    m = _contingency(a, b)
    n = m.sum()
    sum_ij = _pairs(m).sum()
    sum_a = _pairs(m.sum(1)).sum()
    sum_b = _pairs(m.sum(0)).sum()
    total = _pairs(np.asarray(n, dtype=np.float64))
    expected = sum_a * sum_b / max(total, 1e-12)
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    return float((sum_ij - expected) / denom) if abs(denom) > 1e-12 else 1.0
