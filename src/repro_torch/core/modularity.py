"""Modularity (paper Eq. 1), computed with segment reductions.

With both edge directions stored, let S = sum of directed weights = 2m,
in_c = directed weight inside community c, K_c = sum of weighted degrees in
community c.  Then  Q = sum_c [ in_c / S - (K_c / S)^2 ].

Labels may take any int values: they are ranked to [0, K) first, so a
relabeling never changes Q (the JAX package's version drops communities
whose id is >= n).
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import Graph


def modularity(graph: Graph, comm: torch.Tensor) -> torch.Tensor:
    n = graph.n
    _, comm = torch.unique(comm.to(graph.device), return_inverse=True)
    s = graph.total_weight  # = 2m
    csrc = comm[graph.src.long()]
    within = graph.edge_mask & (csrc == comm[graph.dst.long()])
    in_c = torch.zeros(n, dtype=torch.float32, device=graph.device)
    in_c.index_add_(0, csrc, torch.where(within, graph.wgt, 0.0))
    k_c = torch.zeros(n, dtype=torch.float32, device=graph.device)
    k_c.index_add_(0, comm, graph.kdeg)
    s = s.clamp_min(1e-30)   # empty graph: Q := 0, not NaN
    return (in_c / s - (k_c / s) ** 2).sum()
