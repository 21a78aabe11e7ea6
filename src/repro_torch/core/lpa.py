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
from repro_torch.obs.convergence import (
    count_true,
    empty_profile_buffer,
    record_row,
)

__all__ = ["LpaState", "label_hash", "lpa_move", "lpa_move_reference",
           "lpa_run", "neighbors_of", "segment_sum", "threshold_for"]


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


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                sorted_ids: bool = False) -> torch.Tensor:
    """Per-segment sums of ``values`` (1-D) over ids ``seg`` in
    [0, num_segments), each folded left to right in index order from 0.0.

    That is the order of ``jax.ops.segment_sum`` on XLA's CPU, and it does
    not change between runs or devices: ``index_add_`` on CUDA is an
    atomic scatter whose float order is not fixed.  ``segment_reduce`` on a
    2-D (m, 1) input folds each segment in one thread, so a segment of
    millions of entries takes a thread that long: keep the ones whose sum
    is not needed out.  Unless ``sorted_ids``, the ids are first sorted
    stably.

    Integer (and bool) values sum exactly in any order: they come back as
    int64, the differences of one prefix sum at the segment bounds, with
    no fold of a segment in one thread.
    """
    if not sorted_ids:
        seg, order = torch.sort(seg, stable=True)
        values = values[order]
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype,
                          device=seg.device)
    offsets = torch.searchsorted(seg, bounds)
    if not values.is_floating_point():
        csum = torch.zeros(values.numel() + 1, dtype=torch.int64,
                           device=values.device)
        torch.cumsum(values, 0, dtype=torch.int64, out=csum[1:])
        return csum[offsets[1:]] - csum[offsets[:-1]]
    return torch.segment_reduce(values[:, None], "sum", offsets=offsets,
                                axis=0, unsafe=True)[:, 0]


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
    # each padding edge is a run of its own (invalid below): one run of
    # them all would be folded in one thread by segment_sum
    is_start |= key_s == n * (bound + 1) + bound
    run_id = torch.cumsum(is_start, 0) - 1

    run_wgt = segment_sum(wgt_s, run_id, m_pad, sorted_ids=True)
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
            init_active: torch.Tensor | None = None,
            profile: bool = False):
    """Run LPA to convergence: ``delta_n <= threshold`` or iteration cap.

    Faithful to Algorithm 3 lines 1-6.  ``n_real``: the unpadded vertex
    count of a bucketed graph (padding vertices are isolated and inert,
    but the threshold is ``tau * n_real``).  ``init_active`` seeds the
    unprocessed flags.  One scalar is read back per iteration.

    ``profile``: also fill a ``(2 * max_iterations, 3)`` int32 buffer on
    the graph's device, row ``2*it + sweep`` = [candidate count (padding
    vertices left out), changed count, row], and return
    ``(LpaState, buffer)``.  The buffer never feeds back and adds no host
    read.
    """
    n = graph.n
    dev = graph.device
    labels = (torch.arange(n, dtype=torch.int32, device=dev)
              if init_labels is None else init_labels.to(torch.int32))
    active = (torch.ones(n, dtype=torch.bool, device=dev)
              if init_active is None else init_active.to(torch.bool))
    threshold = threshold_for(tau, n, n_real)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    parity = (label_hash(ids, -1) & 1).bool()
    if profile:
        buf = empty_profile_buffer(2 * max_iterations, dev)
        real = ids < (n if n_real is None else n_real)
    else:
        buf = None

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
            if buf is not None:
                row = 2 * it + sweep
                record_row(buf, row, count_true(cand & real), d, row)
        it += 1
        # lint: host-sync-ok — one convergence scalar per iteration
        dn = int(dn_t)
    state = LpaState(labels=labels, active=active, iteration=it, delta_n=dn)
    return (state, buf) if profile else state


def lpa_move_reference(graph: Graph, labels: torch.Tensor,
                       active: torch.Tensor, iteration: int = 0):
    """O(n * n) dense oracle of ``lpa_move`` for small-graph tests.

    Builds the full (n, n) vertex x community weight matrix
    ``W[i, c]`` = the summed weight of i's neighbors j with ``C[j] = c``.
    """
    n = graph.n
    dev = labels.device
    flat = graph.src.long() * n + labels[graph.dst.long()].long()
    w_ic = torch.zeros(n * n, dtype=torch.float32, device=dev).index_add_(
        0, flat, torch.where(graph.edge_mask, graph.wgt, 0.0)).reshape(n, n)
    best_w = w_ic.amax(dim=1)
    # same tie-break as lpa_move: max weight, then max label hash
    is_best = (w_ic >= best_w[:, None]) & (best_w[:, None] > 0)
    h = label_hash(torch.arange(n, dtype=torch.int32, device=dev), iteration)
    best_h = torch.where(is_best, h[None, :], -1).amax(dim=1)
    pick = is_best & (h[None, :] == best_h[:, None])
    best_lab = pick.to(torch.uint8).argmax(dim=1).to(labels.dtype)
    cur_w = w_ic.gather(1, labels[:, None].long())[:, 0]
    adopt = active & (best_w > cur_w) & (best_w > 0)
    new_labels = torch.where(adopt, best_lab, labels)
    changed = new_labels != labels
    return new_labels, changed, changed.sum()
