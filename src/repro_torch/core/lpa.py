"""Parallel Label Propagation (the paper's GVE-LPA core) on the edge list.

The per-vertex hashtables of the paper's ``lpaMove`` become a sort plus
segment reductions over the directed edge list:

  1. for every directed edge (u, v, w) form the key ``u * (bound+1) + C[v]``
     (one int64 key stands in for a two-key lexicographic sort);
  2. stable-sort the edges by that key;
  3. segment-sum the weights over key runs -> K_{u -> c} for every (u, c)
     that occurs;
  4. per source, the best community weight, ties broken by the largest
     per-iteration label hash, then the smallest label;
  5. a vertex adopts the best label only if it is *strictly* better
     connected to it than to its current label.

Pruning is a dense boolean ``active`` mask, and each iteration makes two
semi-synchronous sub-sweeps over hashed parity classes, exactly as the
JAX package does, so labels and iteration counts agree with it.

This is the segment backend's path and the tile backend's oracle; it runs
on any device with plain tensor operations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.kernels.ref import label_hash

__all__ = ["LpaState", "label_hash", "lpa_move", "lpa_run", "neighbors_of",
           "threshold_for"]


class LpaState(NamedTuple):
    labels: torch.Tensor   # (n,) int32 community of each vertex
    active: torch.Tensor   # (n,) bool  unprocessed flags (pruning)
    iteration: int
    delta_n: int           # label changes in the last iteration


def threshold_for(tau: float, n: int, n_real: int | None) -> int:
    """Convergence threshold on the per-iteration change count.

    With a real vertex count (bucketed graphs) the product is taken in
    float32, as the bucketed executables of the JAX package do; without
    one it is the Python-float ``int(tau * n)``.
    """
    if n_real is None:
        return int(tau * n)
    return int(np.float32(tau) * np.float32(n_real))


def _scan_communities(graph: Graph, labels: torch.Tensor,
                      label_bound: int | None = None):
    """Steps 1-3: per-(src, community) connecting weights.

    Returns (run_src, run_lab, run_wgt, run_valid), each (m_pad,) — one
    entry per run of equal keys, the tail beyond the last run invalid.
    ``label_bound`` (default ``graph.n``) is the exclusive upper bound on
    label values, used as the sentinel of padding edges.
    """
    n, m_pad = graph.n, graph.m_pad
    bound = n if label_bound is None else int(label_bound)
    mask = graph.edge_mask
    lab_dst = torch.where(mask, labels[graph.dst].long(), bound)
    src = torch.where(mask, graph.src.long(), n)
    key = src * (bound + 1) + lab_dst
    key_s, order = torch.sort(key, stable=True)
    wgt_s = graph.wgt[order]

    is_start = torch.ones(m_pad, dtype=torch.bool, device=key.device)
    is_start[1:] = key_s[1:] != key_s[:-1]
    run_id = torch.cumsum(is_start, 0) - 1

    run_wgt = torch.zeros(m_pad, dtype=torch.float32, device=key.device)
    run_wgt.index_add_(0, run_id, wgt_s)
    run_key = torch.zeros(m_pad, dtype=torch.int64, device=key.device)
    run_key.scatter_reduce_(0, run_id, key_s, "amax")
    run_valid = torch.zeros(m_pad, dtype=torch.bool, device=key.device)
    run_valid[run_id] = True
    run_src = torch.div(run_key, bound + 1, rounding_mode="floor")
    run_lab = run_key - run_src * (bound + 1)
    run_valid &= (run_lab < bound) & (run_src < n)
    return run_src, run_lab, run_wgt, run_valid


def neighbors_of(graph: Graph, mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask of vertices adjacent to any vertex in ``mask``."""
    hit = (mask[graph.dst] & graph.edge_mask).to(torch.int32)
    out = torch.zeros(graph.n, dtype=torch.int32, device=hit.device)
    out.scatter_reduce_(0, graph.src.long(), hit, "amax")
    return out > 0


def lpa_move(graph: Graph, labels: torch.Tensor, active: torch.Tensor,
             iteration: int = 0, label_bound: int | None = None):
    """One synchronous LPA sweep (the paper's ``lpaMove``) over ``active``.

    Returns (new_labels, changed_mask, delta_n) with ``delta_n`` a 0-d
    tensor (no host sync here).
    """
    n = graph.n
    bound = n if label_bound is None else int(label_bound)
    run_src, run_lab, run_wgt, run_valid = _scan_communities(
        graph, labels, label_bound)
    dev = run_src.device
    seg = torch.where(run_valid, run_src, n - 1)
    w = torch.where(run_valid, run_wgt, -1.0)

    # Step 4: per-source best community weight; tie-break max label hash.
    best_w = torch.full((n,), float("-inf"), device=dev)
    best_w.scatter_reduce_(0, seg, w, "amax")
    bw = best_w[seg]
    is_best = run_valid & (run_wgt >= bw) & (bw > 0)
    run_h = label_hash(run_lab, iteration).long()
    best_h = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_h.scatter_reduce_(0, seg, torch.where(is_best, run_h, -1), "amax")
    pick = is_best & (run_h == best_h[seg])
    best_lab = torch.full((n,), bound, dtype=torch.int64, device=dev)
    best_lab.scatter_reduce_(0, seg, torch.where(pick, run_lab, bound),
                             "amin")

    # Connecting weight to the *current* community (keep unless worse).
    to_cur = run_valid & (run_lab == labels[seg].long())
    cur_w = torch.full((n,), float("-inf"), device=dev)
    cur_w.scatter_reduce_(0, seg, torch.where(to_cur, run_wgt, -1.0), "amax")

    adopt = active & (best_lab < bound) & (best_w > cur_w.clamp_min(0.0))
    new_labels = torch.where(adopt, best_lab.to(labels.dtype), labels)
    changed = new_labels != labels
    return new_labels, changed, changed.sum()


def lpa_run(graph: Graph, tau: float = 0.05, max_iterations: int = 20,
            init_labels: torch.Tensor | None = None,
            n_real: int | None = None,
            init_active: torch.Tensor | None = None) -> LpaState:
    """Run LPA to convergence: ``delta_n <= threshold`` or iteration cap.

    Faithful to Algorithm 3 lines 1-6.  ``n_real``: the unpadded vertex
    count of a bucketed graph (padding vertices are isolated and inert,
    but the threshold is ``tau * n_real``).  ``init_active`` seeds the
    unprocessed flags.  One scalar is read back per iteration.
    """
    n = graph.n
    dev = graph.device
    labels = (torch.arange(n, dtype=torch.int32, device=dev)
              if init_labels is None else init_labels.to(torch.int32))
    active = (torch.ones(n, dtype=torch.bool, device=dev)
              if init_active is None else init_active.to(torch.bool))
    threshold = threshold_for(tau, n, n_real)
    parity = (label_hash(torch.arange(n, dtype=torch.int32, device=dev), -1)
              & 1).bool()

    it, dn = 0, n
    while dn > threshold and it < max_iterations:
        dn_t = torch.zeros((), dtype=torch.int64, device=dev)
        for sweep, klass in enumerate((~parity, parity)):
            cand = active & klass
            labels, changed, d = lpa_move(graph, labels, cand,
                                          2 * it + sweep)
            # pruning: processed vertices sleep; neighbors of changed wake
            active = (active & ~cand) | neighbors_of(graph, changed)
            dn_t += d
        it += 1
        dn = int(dn_t)
    return LpaState(labels=labels, active=active, iteration=it, delta_n=dn)
