"""Finding internally-disconnected communities (paper Appendix A.1, Alg. 4).

The min-label component pass of ``split_lp`` gives one root per
(community, component); a community is disconnected iff it holds two or
more distinct roots.  ``disconnected_communities_host`` is the literal
per-community BFS of Algorithm 4, kept as the oracle.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.graph import Graph, to_numpy_adj
from repro_torch.core.split import split_lp


def disconnected_communities(graph: Graph, comm: torch.Tensor):
    """Returns (flags, n_disconnected, n_communities).

    ``flags`` is an (n,) bool tensor indexed by community label value:
    ``flags[c]`` is True iff community ``c`` is non-empty and internally
    disconnected.  Labels must lie in [0, n).
    """
    n = graph.n
    comm = comm.to(device=graph.device, dtype=torch.int64)
    roots = split_lp(graph, comm).labels.long()
    pairs = torch.unique(comm * n + roots)
    pair_count = torch.bincount(torch.div(pairs, n, rounding_mode="floor"),
                                minlength=n)
    flags = pair_count > 1
    return flags, flags.sum(), (pair_count > 0).sum()


def disconnected_fraction(graph: Graph, comm: torch.Tensor) -> torch.Tensor:
    _, bad, total = disconnected_communities(graph, comm)
    return bad.float() / total.clamp_min(1).float()


def disconnected_communities_host(graph: Graph, comm) -> dict:
    """Host BFS oracle mirroring Algorithm 4 literally (per-community BFS
    from one representative; flag if reached < community size)."""
    adj = to_numpy_adj(graph)
    comm = np.asarray(comm)
    sizes: dict[int, int] = {}
    rep: dict[int, int] = {}
    for i in range(graph.n):
        c = int(comm[i])
        sizes[c] = sizes.get(c, 0) + 1
        rep.setdefault(c, i)
    flags: dict[int, bool] = {}
    for c, seed in rep.items():
        visited = {seed}
        q = deque([seed])
        while q:
            u = q.popleft()
            for v, _w in adj[u]:
                if v not in visited and comm[v] == c:
                    visited.add(v)
                    q.append(v)
        flags[c] = len(visited) < sizes[c]
    return flags
