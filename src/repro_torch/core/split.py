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

_INT32_MAX = 2147483647


class SplitState(NamedTuple):
    labels: torch.Tensor   # (n,) int32 minimum-label per (community, component)
    active: torch.Tensor   # (n,) bool  pruning flags (LPP only)
    iterations: int
    delta_n: int


def _min_label_sweep(graph: Graph, comm: torch.Tensor, labels: torch.Tensor,
                     active: torch.Tensor, prune: bool, shortcut: bool):
    """One sweep of Algorithm 1's loop body (lines 8-21), vectorised."""
    n = graph.n
    src = graph.src.long()
    same = graph.edge_mask & (comm[graph.src] == comm[graph.dst])
    cand = torch.where(same, labels[graph.dst], n)
    nbr_min = torch.full((n,), _INT32_MAX, dtype=labels.dtype,
                         device=labels.device)
    nbr_min.scatter_reduce_(0, src, cand.to(labels.dtype), "amin")
    new = torch.minimum(labels, nbr_min)
    if prune:
        new = torch.where(active, new, labels)
    if shortcut:  # pointer jump (beyond-paper)
        new = torch.minimum(new, new[new])
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
             shortcut: bool = False) -> SplitState:
    """Algorithm 1: SL-LP (``prune=False``) / SL-LPP (``prune=True``).

    Each vertex ends with the minimum vertex id reachable within its
    community and connected component: one label per component per
    community, which is exactly the split partition.
    """
    n = graph.n
    dev = graph.device
    comm = comm.to(torch.int32)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    it, dn = 0, n
    while dn > 0:
        labels, active, _, d = _min_label_sweep(graph, comm, labels, active,
                                                prune, shortcut)
        it += 1
        dn = int(d)
    return SplitState(labels=labels, active=active, iterations=it, delta_n=dn)


def split_lpp(graph: Graph, comm: torch.Tensor,
              shortcut: bool = False) -> SplitState:
    return split_lp(graph, comm, prune=True, shortcut=shortcut)


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
