"""The LPA baselines the paper compares against (its Fig. 4).

Each keeps its algorithm's defining feature, as the JAX package's
``core/baselines.py`` does, with the same order of random draws, so both
give the same labels:

* ``flpa_host``: FLPA (Traag & Subelj 2023), a FIFO queue of vertices
  whose neighborhood changed; only those are rescanned.  Host code.
* ``igraph_lpa_host``: igraph's LPA, sequential asynchronous sweeps in a
  random vertex order until a full pass changes nothing.  Host code.
* ``networkit_plp``: NetworKit's PLP, synchronous parallel sweeps with an
  update threshold (``theta = n / 1e5``, its default) and no pruning: a
  loop over ``core.lpa.lpa_move`` on the device.

The host baselines break ties to the largest weight, then the smallest
label, keeping the current label on a tie.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.graph import Graph, to_numpy_adj
from repro_torch.core.lpa import lpa_move

__all__ = ["flpa_host", "igraph_lpa_host", "networkit_plp"]


def _best_label(adj_i, labels, cur) -> int:
    acc: dict[int, float] = {}
    for j, w in adj_i:
        c = int(labels[j])
        acc[c] = acc.get(c, 0.0) + w
    if not acc:
        return cur
    best_w = max(acc.values())
    if acc.get(cur, -1.0) >= best_w:
        return cur
    return min(c for c, w in acc.items() if w >= best_w)


def flpa_host(graph: Graph, max_passes: int = 100) -> np.ndarray:
    """Fast Label Propagation: queue-driven updates, at most
    ``max_passes * n`` vertex visits."""
    adj = to_numpy_adj(graph)
    n = graph.n
    labels = np.arange(n, dtype=np.int64)
    inq = np.ones(n, dtype=bool)
    q = deque(range(n))
    steps = 0
    limit = max_passes * n
    while q and steps < limit:
        i = q.popleft()
        inq[i] = False
        steps += 1
        c = _best_label(adj[i], labels, int(labels[i]))
        if c != labels[i]:
            labels[i] = c
            for j, _w in adj[i]:
                if labels[j] != c and not inq[j]:
                    inq[j] = True
                    q.append(j)
    return labels.astype(np.int32)


def igraph_lpa_host(graph: Graph, seed: int = 0,
                    max_passes: int = 50) -> np.ndarray:
    """Sequential asynchronous LPA in a shuffled order per pass
    (``np.random.default_rng(seed).permutation``)."""
    adj = to_numpy_adj(graph)
    rng = np.random.default_rng(seed)
    n = graph.n
    labels = np.arange(n, dtype=np.int64)
    for _ in range(max_passes):
        changed = 0
        for i in rng.permutation(n):
            c = _best_label(adj[i], labels, int(labels[i]))
            if c != labels[i]:
                labels[i] = c
                changed += 1
        if changed == 0:
            break
    return labels.astype(np.int32)


def networkit_plp(graph: Graph, theta: float | None = None,
                  max_iterations: int = 100, device=None) -> np.ndarray:
    """PLP: synchronous sweeps of every vertex until at most ``theta``
    labels change.  ``device``: where the sweeps run; None is the card."""
    dev = torch.device("cuda" if device is None else device)
    graph = graph.to(dev)
    n = graph.n
    if theta is None:
        theta = max(n / 1e5, 1.0)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for it in range(max_iterations):
        labels, _changed, dn = lpa_move(graph, labels, active, it)
        # lint: host-sync-ok — PLP's stop test, one count per sweep
        if int(dn) <= theta:
            break
    return labels.cpu().numpy()
