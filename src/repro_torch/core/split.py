"""Split-Last (SL): separate internally-disconnected communities.

The paper's three techniques (Section 4):

* ``split_lp``   — Algorithm 1, minimum-label Label Propagation (SL-LP).
* ``split_lpp``  — Algorithm 1 with pruning (SL-LPP).
* ``split_bfs_host`` — Algorithm 2, per-community BFS on the host.

``shortcut=True`` adds pointer shortcutting (``L <- min(L, L[L])`` after
each neighbor-min sweep, beyond the paper): labels always point at a vertex
of the same community and component, so it is sound, and it collapses
convergence from O(diameter) to O(log diameter) sweeps.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.obs.convergence import (
    count_true,
    empty_profile_buffer,
    record_row,
)

_INT32_MAX = 2147483647


class SplitState(NamedTuple):
    labels: torch.Tensor   # (n,) int32 minimum-label per (community, component)
    active: torch.Tensor   # (n,) bool  pruning flags (LPP only)
    iterations: int
    delta_n: int


def _min_label_sweep(graph: Graph, comm: torch.Tensor, labels: torch.Tensor,
                     active: torch.Tensor, prune: bool, shortcut: bool,
                     voffset: torch.Tensor | None = None,
                     label_bound: int | None = None):
    """One sweep of Algorithm 1's loop body (lines 8-21), vectorised.

    ``voffset``: per-vertex owner offsets when labels are in per-graph
    *local* coordinates (the batched path): the shortcut's pointer jump
    gathers at the label's global row, ``label + voffset``.

    ``label_bound``: exclusive upper bound on label values, the sentinel
    of edges to another community.  Defaults to ``graph.n``; a partition's
    local rows carry *global* labels, so the out-of-core path passes the
    whole graph's vertex count.
    """
    n = graph.n
    bound = n if label_bound is None else int(label_bound)
    src = graph.src.long()
    same = graph.edge_mask & (comm[graph.src] == comm[graph.dst])
    cand = torch.where(same, labels[graph.dst], bound)
    nbr_min = torch.full((n,), _INT32_MAX, dtype=labels.dtype,
                         device=labels.device)
    nbr_min.scatter_reduce_(0, src, cand.to(labels.dtype), "amin")
    new = torch.minimum(labels, nbr_min)
    if prune:
        new = torch.where(active, new, labels)
    if shortcut:  # pointer jump (beyond-paper)
        new = torch.minimum(new, new[new if voffset is None
                                     else new + voffset])
    changed = new != labels
    if prune:
        # reactivate same-community neighbors of changed vertices
        hit = (changed[graph.dst] & same).to(torch.int32)
        wake = torch.zeros(n, dtype=torch.int32, device=labels.device)
        wake.scatter_reduce_(0, src, hit, "amax")
        nxt_active = wake > 0
    else:
        nxt_active = active
    return new, nxt_active, changed, changed.sum()


def split_lp(graph: Graph, comm: torch.Tensor, prune: bool = False,
             shortcut: bool = False, profile_rows: int = 0,
             n_real: int | None = None):
    """Algorithm 1: SL-LP (``prune=False``) / SL-LPP (``prune=True``).

    Each vertex ends with the minimum vertex id reachable within its
    community and connected component: one label per component per
    community, which is exactly the split partition.

    ``profile_rows`` (0 = off): also fill a ``(profile_rows, 3)`` int32
    buffer on the device, row ``min(iterations, profile_rows - 1)`` =
    [active count, changed count, iterations] (a split that outruns the
    buffer overwrites its last row), and return ``(SplitState, buffer)``.
    ``n_real`` leaves bucket-padding vertices out of the active counts;
    it does not change the sweep.
    """
    n = graph.n
    dev = graph.device
    comm = comm.to(torch.int32)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    if profile_rows:
        buf = empty_profile_buffer(profile_rows, dev)
        real = labels < (n if n_real is None else n_real)
    else:
        buf = None
    it, dn = 0, n
    while dn > 0:
        prev_active = active
        labels, active, _, d = _min_label_sweep(graph, comm, labels, active,
                                                prune, shortcut)
        if buf is not None:
            record_row(buf, min(it, profile_rows - 1),
                       count_true(prev_active & real), d, it)
        it += 1
        dn = int(d)
    state = SplitState(labels=labels, active=active, iterations=it,
                       delta_n=dn)
    return (state, buf) if profile_rows else state


def split_lpp(graph: Graph, comm: torch.Tensor,
              shortcut: bool = False) -> SplitState:
    return split_lp(graph, comm, prune=True, shortcut=shortcut)


def min_label_sweep(graph: Graph, comm: torch.Tensor, labels: torch.Tensor,
                    active: torch.Tensor, label_bound: int,
                    prune: bool = False) -> torch.Tensor:
    """Partition-local split sweep: one Algorithm-1 step over a CSR slice.

    The out-of-core loop (:mod:`repro_torch.partition.ooc`) runs the
    Split-Last phase one partition at a time: ``graph`` is a compact local
    subgraph (owned rows, then halo rows), ``comm`` / ``labels`` carry
    *global* community ids and split labels gathered for those rows, and
    ``label_bound`` is the whole graph's vertex count.  The sweep is
    synchronous, so sweeping the partitions one after another against one
    snapshot reproduces the in-core :func:`split_lp` sweep bit for bit.
    The pointer-jump shortcut needs the whole label array, so it is not
    applied here; the loop applies it after assembling the sweep.
    Returns the new labels (before any shortcut).
    """
    new, _, _, _ = _min_label_sweep(graph, comm, labels, active,
                                    prune=prune, shortcut=False,
                                    label_bound=label_bound)
    return new


def min_label_wake(graph: Graph, comm: torch.Tensor,
                   changed: torch.Tensor) -> torch.Tensor:
    """Pruning reactivation of a partition-local split sweep.

    A vertex re-enters the SL-LPP worklist exactly when a same-community
    neighbor changed label in the previous sweep (Algorithm 1 lines
    20-21).  ``changed`` holds the previous sweep's changed flags gathered
    to this slice's local rows; the slice's own edges suffice, because the
    rule reads each vertex's *own* neighborhood.
    """
    same = graph.edge_mask & (comm[graph.src] == comm[graph.dst])
    hit = (changed[graph.dst] & same).to(torch.int32)
    wake = torch.zeros(graph.n, dtype=torch.int32, device=hit.device)
    wake.scatter_reduce_(0, graph.src.long(), hit, "amax")
    return wake > 0


def split_bfs_host(graph: Graph, comm) -> np.ndarray:
    """Algorithm 2: per-community BFS splitting (host path).

    Each still-unvisited vertex seeds a BFS restricted to its community;
    every reached vertex adopts the seed's id as its new label.
    """
    row_ptr = graph.row_ptr.cpu().numpy().tolist()
    dst = graph.dst[: graph.num_edges].cpu().numpy().tolist()
    comm = np.asarray(comm.cpu() if torch.is_tensor(comm) else comm).tolist()
    n = graph.n
    out = np.arange(n, dtype=np.int32)
    visited = [False] * n
    for i in range(n):
        if visited[i]:
            continue
        visited[i] = True
        ci = comm[i]
        q = deque([i])
        while q:
            u = q.popleft()
            out[u] = i
            for v in dst[row_ptr[u]:row_ptr[u + 1]]:
                if not visited[v] and comm[v] == ci:
                    visited[v] = True
                    q.append(v)
    return out


def compact_labels(labels: torch.Tensor) -> torch.Tensor:
    """Relabel communities to a dense [0, K) range (rank order of values)."""
    _, inv = torch.unique(labels, return_inverse=True)
    return inv.to(torch.int32)


def num_communities(labels: torch.Tensor) -> int:
    return int(torch.unique(labels).numel())
