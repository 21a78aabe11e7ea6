"""Synthetic graph generators (host-side numpy).

The edge lists are drawn with numpy exactly as the JAX package draws them,
so the same seed gives the same graph in both packages.  Each generator
takes ``device`` for the returned graph's tensors.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, build_graph


def erdos_renyi(n: int, avg_degree: float, seed: int = 0,
                device="cpu") -> Graph:
    """G(n, p) with p chosen to hit ``avg_degree``."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    e = e[e[:, 0] != e[:, 1]][:m]
    return build_graph(e, n=n, device=device)


def sbm(sizes: list[int], p_in: float, p_out: float, seed: int = 0,
        device="cpu") -> tuple[Graph, np.ndarray]:
    """Stochastic block model; returns (graph, ground-truth membership)."""
    rng = np.random.default_rng(seed)
    n = int(sum(sizes))
    bounds = np.cumsum([0] + list(sizes))
    truth = np.zeros(n, dtype=np.int32)
    edges = []
    for b in range(len(sizes)):
        lo, hi = bounds[b], bounds[b + 1]
        truth[lo:hi] = b
        # intra-block edges
        nb = hi - lo
        m_in = int(p_in * nb * (nb - 1) / 2)
        if m_in:
            e = rng.integers(lo, hi, size=(m_in, 2))
            edges.append(e)
        # inter-block edges to later blocks
        for b2 in range(b + 1, len(sizes)):
            lo2, hi2 = bounds[b2], bounds[b2 + 1]
            m_out = int(p_out * nb * (hi2 - lo2))
            if m_out:
                e = np.stack([rng.integers(lo, hi, size=m_out),
                              rng.integers(lo2, hi2, size=m_out)], axis=1)
                edges.append(e)
    e = np.concatenate(edges, axis=0)
    e = e[e[:, 0] != e[:, 1]]
    return build_graph(e, n=n, device=device), truth


def planted_partition(n_comm: int, comm_size: int, p_in: float = 0.3,
                      p_out: float = 0.002, seed: int = 0, device="cpu",
                      ) -> tuple[Graph, np.ndarray]:
    return sbm([comm_size] * n_comm, p_in, p_out, seed, device=device)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, device="cpu") -> Graph:
    """Kronecker/RMAT power-law graph (Graph500-style parameters)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    srcs = np.zeros(m, dtype=np.int64)
    dsts = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random((m, 2))
        go_right_src = r[:, 0] > (a + b)      # pick bottom half for src
        # conditional for dst depends on src half
        p_right_top, p_right_bot = b / (a + b), 1.0 - c / (1.0 - a - b + 1e-12)
        go_right_dst = np.where(go_right_src,
                                r[:, 1] > (1.0 - p_right_bot),
                                r[:, 1] < p_right_top)
        srcs |= go_right_src.astype(np.int64) << bit
        dsts |= go_right_dst.astype(np.int64) << bit
    e = np.stack([srcs, dsts], axis=1)
    e = e[e[:, 0] != e[:, 1]]
    return build_graph(e, n=n, device=device)


def grid2d(side: int, device="cpu") -> Graph:
    """2D lattice — degree ~2.1 road-network proxy (asia_osm analogue)."""
    idx = np.arange(side * side).reshape(side, side)
    edges = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
    ])
    return build_graph(edges, n=side * side, device=device)


def ring_of_cliques(n_cliques: int, clique_size: int, device="cpu") -> Graph:
    """Classic modularity testbed: cliques joined in a ring by single edges."""
    edges = []
    for q in range(n_cliques):
        base = q * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((q + 1) % n_cliques) * clique_size
        edges.append((base, nxt))
    return build_graph(np.array(edges), n=n_cliques * clique_size,
                       device=device)


def karate_club(device="cpu") -> tuple[Graph, np.ndarray]:
    """Zachary's karate club (34 vertices, 78 edges) + 2-faction ground truth."""
    e = [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
         (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
         (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
         (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
         (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
         (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
         (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
         (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
         (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
         (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
         (30, 33), (31, 32), (31, 33), (32, 33)]
    faction = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0,
                        1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                       dtype=np.int32)
    return build_graph(np.array(e), n=34, device=device), faction


def figure1_graph(device="cpu") -> tuple[Graph, np.ndarray, np.ndarray]:
    """The paper's Figure 1 / Figure 2 scenario.

    Vertices 0..6 form community C1 in two lobes {0,1,2} and {4,5,6} bridged
    only through the cut vertex 3; vertices 7..9 form a heavy community C2
    that vertex 3 defects to, internally disconnecting C1.

    Returns (graph, assignment_before, assignment_after_defection); the
    "after" assignment exhibits the internally-disconnected C1 and is the
    canonical test input for detection + splitting.
    """
    edges = [
        # lobe A of C1
        (0, 1), (1, 2), (0, 2),
        # bridge through cut vertex 3
        (2, 3), (3, 4),
        # lobe B of C1
        (4, 5), (5, 6), (4, 6),
        # community C2 (heavy internal weights)
        (7, 8), (8, 9), (7, 9),
        # vertex 3's strong pull toward C2
        (3, 7), (3, 8), (3, 9),
    ]
    w = [1, 1, 1,
         1, 1,
         1, 1, 1,
         4, 4, 4,
         4, 4, 4]
    g = build_graph(np.array(edges), np.array(w, dtype=np.float32), n=10,
                    device=device)
    before = np.array([1, 1, 1, 1, 1, 1, 1, 2, 2, 2], dtype=np.int32)
    after = np.array([1, 1, 1, 2, 1, 1, 1, 2, 2, 2], dtype=np.int32)
    return g, before, after
