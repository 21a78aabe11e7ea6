"""Graph representation for the PyTorch GSL-LPA engine.

A ``Graph`` holds a padded CSR / edge-list hybrid as tensors on one device:
edges are stored *directed both ways* (undirected graph semantics, as in
the paper) and sorted by source vertex, so ``src`` is the CSR expansion of
``row_ptr``.  Padding slots (up to ``m_pad``, a multiple of 128) carry
``src = dst = 0``, ``wgt = 0`` and ``edge_mask = False``.  The edge padding
keeps the arrays (and hence the structural fingerprint) identical to the
JAX package's for the same edge list.

Host-side construction is numpy; the resulting arrays are moved to the
requested device once.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

_EDGE_ALIGN = 128  # edge-array padding multiple (keeps fingerprints stable)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded undirected graph (both edge directions materialised)."""
    n: int          # number of vertices
    m_pad: int      # padded directed edge count
    num_edges: int  # actual directed edge count (2x undirected)
    row_ptr: torch.Tensor    # (n + 1,) int32, CSR offsets into src/dst/wgt
    src: torch.Tensor        # (m_pad,) int32, edge sources (sorted)
    dst: torch.Tensor        # (m_pad,) int32, edge destinations
    wgt: torch.Tensor        # (m_pad,) float32, edge weights (0 on padding)
    edge_mask: torch.Tensor  # (m_pad,) bool, True for real edges
    kdeg: torch.Tensor       # (n,) float32, weighted degree K_i

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def total_weight(self) -> torch.Tensor:
        """Sum of directed edge weights == 2m in the paper's notation."""
        return self.wgt.sum()

    def to(self, device) -> "Graph":
        """The same graph on ``device`` (itself when already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        moved = dataclasses.replace(self, **{
            f: getattr(self, f).to(device)
            for f in ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")})
        fp = getattr(self, "_fingerprint", None)
        if fp is not None:
            object.__setattr__(moved, "_fingerprint", fp)
        return moved


def _fingerprint(n: int, num_edges: int, row_ptr: np.ndarray,
                 dst: np.ndarray) -> tuple:
    return (int(n), int(num_edges),
            zlib.crc32(np.ascontiguousarray(row_ptr, np.int32).tobytes()),
            zlib.crc32(np.ascontiguousarray(dst, np.int32).tobytes()))


def graph_from_arrays(n: int, num_edges: int, row_ptr, src, dst, wgt,
                      edge_mask, kdeg, device="cpu") -> Graph:
    """Wrap host CSR arrays (numpy) as a :class:`Graph` on ``device``.

    The arrays keep their lengths: ``m_pad`` is ``len(src)``.  This is how a
    graph built elsewhere (a file reader, another implementation of the
    same format) is fitted bit-for-bit on the same structure.
    """
    def host(a, dtype):   # writable and contiguous: torch shares it as is
        return np.require(a, dtype, requirements=["C", "W"])

    row_ptr, src, dst = (host(a, np.int32) for a in (row_ptr, src, dst))
    wgt, kdeg = host(wgt, np.float32), host(kdeg, np.float32)
    edge_mask = host(edge_mask, bool)
    m_pad = len(src)
    if row_ptr.shape != (n + 1,) or kdeg.shape != (n,):
        raise ValueError(f"row_ptr/kdeg shapes {row_ptr.shape}/{kdeg.shape} "
                         f"do not match n={n}")
    if not (len(dst) == len(wgt) == len(edge_mask) == m_pad) \
            or num_edges > m_pad:
        raise ValueError("edge arrays must share one length >= num_edges")
    dev = torch.device(device)
    graph = Graph(
        n=int(n), m_pad=int(m_pad), num_edges=int(num_edges),
        row_ptr=torch.from_numpy(row_ptr).to(dev),
        src=torch.from_numpy(src).to(dev),
        dst=torch.from_numpy(dst).to(dev),
        wgt=torch.from_numpy(wgt).to(dev),
        edge_mask=torch.from_numpy(edge_mask).to(dev),
        kdeg=torch.from_numpy(kdeg).to(dev),
    )
    # Fingerprint eagerly while the CSR is still host memory.
    object.__setattr__(graph, "_fingerprint",
                       _fingerprint(n, num_edges, row_ptr, dst))
    return graph


def build_graph(edges: np.ndarray, weights: np.ndarray | None = None,
                n: int | None = None, symmetrize: bool = True,
                device="cpu") -> Graph:
    """Build a :class:`Graph` from an undirected edge list.

    Args:
      edges: (E, 2) int array of endpoints.  Self loops are dropped
        (``scanCommunities`` excludes i == j).  Duplicate edges are merged
        with their weights summed.
      weights: (E,) float array; defaults to unit weights (paper default).
      n: vertex count; defaults to ``edges.max() + 1``.
      symmetrize: materialise both directions (paper: undirected).
      device: where the graph's tensors live.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64).reshape(-1)
    if n is None:
        n = int(edges.max()) + 1 if len(edges) else 1

    keep = edges[:, 0] != edges[:, 1]
    edges, weights = edges[keep], weights[keep]
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        weights = np.concatenate([weights, weights], axis=0)

    # Merge duplicates: sort by (src, dst), sum weights over runs.
    key = edges[:, 0] * n + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key, weights = key[order], weights[order]
    is_start = np.ones(len(key), dtype=bool)
    is_start[1:] = key[1:] != key[:-1]
    uniq = key[is_start]
    run = np.cumsum(is_start) - 1
    # sequential accumulation in sorted order, as np.add.at would do
    wsum = np.bincount(run, weights=weights, minlength=len(uniq))
    usrc = (uniq // n).astype(np.int32)
    udst = (uniq % n).astype(np.int32)

    num_edges = len(uniq)
    m_pad = max(_round_up(num_edges, _EDGE_ALIGN), _EDGE_ALIGN)
    src = np.zeros(m_pad, dtype=np.int32)
    dst = np.zeros(m_pad, dtype=np.int32)
    wgt = np.zeros(m_pad, dtype=np.float32)
    mask = np.zeros(m_pad, dtype=bool)
    src[:num_edges], dst[:num_edges] = usrc, udst
    wgt[:num_edges] = wsum.astype(np.float32)
    mask[:num_edges] = True

    counts = np.bincount(usrc, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    kdeg = np.bincount(usrc, weights=wsum, minlength=n)
    return graph_from_arrays(n, num_edges, row_ptr, src, dst, wgt, mask,
                             kdeg.astype(np.float32), device=device)


def graph_fingerprint(graph: Graph) -> tuple:
    """Cheap structural identity: (n, m, crc of offsets, crc of dst).

    Weights are deliberately excluded.  Memoized on the instance, so a
    graph re-fitted many times pays the device-to-host copy once.
    """
    fp = getattr(graph, "_fingerprint", None)
    if fp is None:
        fp = _fingerprint(graph.n, graph.num_edges,
                          graph.row_ptr.cpu().numpy(),
                          graph.dst.cpu().numpy())
        object.__setattr__(graph, "_fingerprint", fp)
    return fp


def to_numpy_adj(graph: Graph) -> list[list[tuple[int, float]]]:
    """Host adjacency list (small graphs: oracles and tests)."""
    m = graph.num_edges
    src = graph.src[:m].cpu().tolist()
    dst = graph.dst[:m].cpu().tolist()
    wgt = graph.wgt[:m].cpu().tolist()
    adj: list[list[tuple[int, float]]] = [[] for _ in range(graph.n)]
    for s, d, w in zip(src, dst, wgt):
        adj[s].append((d, w))
    return adj


def to_padded_neighbors(graph: Graph, d_max: int | None = None,
                        rows: int | None = None,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense padded neighbor tiles for the tile backend, on the graph's device.

    Returns (nbr, nw, nmask) with shapes (rows, d_max): neighbor vertex ids
    (int32), weights (float32) and validity (bool).  ``rows`` defaults to
    ``graph.n`` and ``d_max`` to the maximum degree.  Pad slots point at
    the row vertex itself with weight 0 and mask False (self edges are
    excluded by construction, so a pad slot can never win the argmax).
    Rows of degree above ``d_max`` keep their first ``d_max`` neighbors.
    Built with one scatter, no per-row loop.
    """
    dev = graph.device
    rows = graph.n if rows is None else int(rows)
    if rows < graph.n:
        raise ValueError(f"rows={rows} is below the vertex count {graph.n}")
    m = graph.num_edges
    row_ptr = graph.row_ptr.long()
    if d_max is None:
        deg = row_ptr[1:] - row_ptr[:-1]
        d_max = max(int(deg.max()) if graph.n else 1, 1)
    src = graph.src[:m].long()
    col = torch.arange(m, device=dev) - row_ptr[src]
    keep = col < d_max
    src, col = src[keep], col[keep]
    nbr = torch.arange(rows, dtype=torch.int32,
                       device=dev)[:, None].repeat(1, d_max)
    nw = torch.zeros((rows, d_max), dtype=torch.float32, device=dev)
    nmask = torch.zeros((rows, d_max), dtype=torch.bool, device=dev)
    nbr[src, col] = graph.dst[:m][keep]
    nw[src, col] = graph.wgt[:m][keep]
    nmask[src, col] = True
    return nbr, nw, nmask
