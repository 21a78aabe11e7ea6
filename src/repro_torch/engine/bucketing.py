"""Shape bucketing: pad graphs to canonical shapes so plans are reused.

Bucketing rounds the vertex, edge and degree counts up to the next power of
two (with floors), pads the graph with isolated vertices and masked edges
to the bucket shape, and keys the engine's plan cache on the bucket.
Padded vertices have no edges, so they never adopt or donate a label; the
only coupling is the convergence threshold, which the backends compute from
the *real* vertex count.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import Graph


class BucketKey(NamedTuple):
    """Canonical padded shapes — the plan-cache key's shape component."""
    n: int   # vertex bucket (>= real n)
    m: int   # directed-edge bucket (>= real m_pad)
    d: int   # max-degree bucket (tile width)


def next_pow2(x: int, floor: int = 1) -> int:
    return max(int(floor), 1 << max(int(x) - 1, 0).bit_length())


def max_degree(graph: Graph) -> int:
    deg = graph.row_ptr[1:] - graph.row_ptr[:-1]
    return int(deg.max()) if deg.numel() else 1


def bucket_for(graph: Graph, *, bucketing: str = "pow2",
               min_vertex_bucket: int = 256,
               min_edge_bucket: int = 2048) -> BucketKey:
    d_real = max(max_degree(graph), 1)
    if bucketing == "exact":
        return BucketKey(n=graph.n, m=graph.m_pad, d=d_real)
    return BucketKey(n=next_pow2(graph.n, min_vertex_bucket),
                     m=next_pow2(graph.m_pad, min_edge_bucket),
                     d=next_pow2(d_real))


def pad_graph(graph: Graph, bucket: BucketKey) -> Graph:
    """Pad a graph up to its bucket shape (itself when already there).

    Vertices ``graph.n .. bucket.n`` are isolated; edge slots up to
    ``bucket.m`` are masked out.  ``num_edges`` is set to the bucket edge
    count: host helpers must be given the *original* graph.
    """
    if graph.n == bucket.n and graph.m_pad == bucket.m:
        return graph
    if graph.n > bucket.n or graph.m_pad > bucket.m:
        raise ValueError(f"graph (n={graph.n}, m_pad={graph.m_pad}) exceeds "
                         f"bucket {bucket}")
    extra_m = bucket.m - graph.m_pad
    extra_n = bucket.n - graph.n

    def pad1(t, amount):
        return torch.cat([t, t.new_zeros(amount)]) if amount else t

    row_ptr = torch.cat([graph.row_ptr, graph.row_ptr[-1:].expand(extra_n)]) \
        if extra_n else graph.row_ptr
    return Graph(n=bucket.n, m_pad=bucket.m, num_edges=bucket.m,
                 row_ptr=row_ptr, src=pad1(graph.src, extra_m),
                 dst=pad1(graph.dst, extra_m), wgt=pad1(graph.wgt, extra_m),
                 edge_mask=pad1(graph.edge_mask, extra_m),
                 kdeg=pad1(graph.kdeg, extra_n))


def pad_active(active: np.ndarray | None, n_real: int,
               n_bucket: int) -> np.ndarray:
    """Pad an (n_real,) unprocessed-seed mask to the bucket.

    ``None`` (a full detection) seeds every row active, padded rows
    included (they are edgeless, hence inert); an explicit mask seeds
    padded rows asleep.
    """
    if active is None:
        return np.ones(n_bucket, dtype=bool)
    active = np.asarray(active, dtype=bool).reshape(-1)
    if len(active) != n_real:
        raise ValueError(f"init_active has {len(active)} entries for a "
                         f"graph with {n_real} vertices")
    return np.concatenate([active, np.zeros(n_bucket - n_real, dtype=bool)])


def pad_labels(labels: np.ndarray, n_real: int, n_bucket: int) -> np.ndarray:
    """Pad an (n_real,) init-label vector to the bucket: padded vertices
    keep their own ids (singleton communities, the LPA invariant)."""
    labels = np.asarray(labels, dtype=np.int32).reshape(-1)
    if len(labels) != n_real:
        raise ValueError(f"init_labels has {len(labels)} entries for a "
                         f"graph with {n_real} vertices")
    if np.any(labels < 0) or np.any(labels >= n_real):
        raise ValueError("init_labels must be vertex-id-valued in [0, n)")
    return np.concatenate(
        [labels, np.arange(n_real, n_bucket, dtype=np.int32)])
