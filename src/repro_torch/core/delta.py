"""Streaming graph deltas: edge insertions and deletions on evolving graphs.

A :class:`GraphDelta` is one update to a graph already detected
(undirected edge insertions with weights, plus deletions).
:func:`apply_delta` rebuilds the CSR :class:`Graph` after the update,
:func:`apply_delta_patch` splices only the touched rows (same bytes,
no sort), and :func:`affected_frontier` marks the vertices whose
neighbourhoods changed: GVE-LPA's unprocessed seeds for a warm re-detection
(``Engine.fit(post, init_labels=prev, init_active=frontier)``).

Delta semantics (host numpy, as ``build_graph``):

* edges are undirected and canonicalised to ``(min, max)`` endpoint pairs;
  self loops are dropped;
* deleting an edge removes it whatever its weight; deleting an edge that
  does not exist is a silent no-op;
* inserting an edge that exists adds the weights, as ``build_graph`` merges
  duplicate input edges;
* the vertex count may grow (``num_vertices`` or an endpoint beyond the
  range) but never shrink: community ids are vertex ids.

A graph on the card has each CSR array read back to the host once per
call; the result lives on the input graph's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import (
    _EDGE_ALIGN,
    Graph,
    _round_up,
    build_graph,
    graph_from_arrays,
)


def _canonical_pairs(edges, weights=None):
    """(E, 2) int64 rows with u < v, self loops dropped; weights (if given)
    ride along the same filter."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if np.any(edges < 0):
        raise ValueError("edge endpoints must be non-negative vertex ids")
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    keep = lo != hi
    pairs = np.stack([lo[keep], hi[keep]], axis=1)
    if weights is None:
        return pairs, None
    weights = np.asarray(weights, dtype=np.float32).reshape(-1)
    if len(weights) != len(edges):
        raise ValueError(f"weights has {len(weights)} entries for "
                         f"{len(edges)} inserted edges")
    return pairs, weights[keep]


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One update to an evolving graph: insert / delete undirected edges.

    Build it with :meth:`make`, which orders endpoints, drops self loops
    and defaults the weights to 1.0.
    """
    insertions: np.ndarray      # (I, 2) int64 canonical (u < v) pairs
    insert_weights: np.ndarray  # (I,) float32
    deletions: np.ndarray       # (D, 2) int64 canonical (u < v) pairs
    num_vertices: int | None = None  # grow the vertex count to at least this

    @classmethod
    def make(cls, insert=None, delete=None, weights=None,
             num_vertices: int | None = None) -> "GraphDelta":
        ins, w = _canonical_pairs(
            insert if insert is not None else np.zeros((0, 2), np.int64),
            weights)
        if w is None:
            w = np.ones(len(ins), dtype=np.float32)
        dels, _ = _canonical_pairs(
            delete if delete is not None else np.zeros((0, 2), np.int64))
        return cls(insertions=ins, insert_weights=w, deletions=dels,
                   num_vertices=num_vertices)

    @property
    def num_insertions(self) -> int:
        return len(self.insertions)

    @property
    def num_deletions(self) -> int:
        return len(self.deletions)

    def is_empty(self) -> bool:
        return not (self.num_insertions or self.num_deletions)

    def touched_vertices(self) -> np.ndarray:
        """Sorted unique endpoints of every inserted or deleted edge."""
        return np.unique(np.concatenate([self.insertions.reshape(-1),
                                         self.deletions.reshape(-1)]))


def _grown_n(n_old: int, delta: GraphDelta) -> int:
    n_new = n_old
    if delta.num_vertices is not None:
        if delta.num_vertices < n_old:
            raise ValueError(
                f"delta shrinks the graph ({delta.num_vertices} < "
                f"{n_old} vertices); vertex removal is unsupported")
        n_new = delta.num_vertices
    if delta.num_insertions:
        n_new = max(n_new, int(delta.insertions.max()) + 1)
    return n_new


def _live_deletions(delta: GraphDelta, n: int) -> np.ndarray:
    """Deletions with both endpoints in range: only those can name a real
    edge (an out-of-range endpoint in a ``u * n + v`` key would collide
    with an unrelated in-range edge's key)."""
    return delta.deletions[(delta.deletions < n).all(axis=1)]


def undirected_edges(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The (E, 2) undirected edge list (u < v) and its float32 weights.

    Both directions are stored with equal weight, so the u < v half is the
    whole undirected edge set.
    """
    m = graph.num_edges
    src = graph.src[:m].cpu().numpy().astype(np.int64)
    dst = graph.dst[:m].cpu().numpy().astype(np.int64)
    wgt = graph.wgt[:m].cpu().numpy()
    keep = src < dst
    return np.stack([src[keep], dst[keep]], axis=1), wgt[keep]


def apply_delta(graph: Graph, delta: GraphDelta) -> Graph:
    """Rebuild the CSR graph after a delta (host, O((m + |delta|) log m)).

    Returns a new :class:`Graph` on the input's device; the input is
    untouched.  An empty delta reproduces the same structure (same
    fingerprint).
    """
    n_new = _grown_n(graph.n, delta)
    edges, weights = undirected_edges(graph)
    dels = _live_deletions(delta, n_new)
    if len(dels):
        key = edges[:, 0] * n_new + edges[:, 1]
        keep = ~np.isin(key, dels[:, 0] * n_new + dels[:, 1])
        edges, weights = edges[keep], weights[keep]
    if delta.num_insertions:
        edges = np.concatenate([edges, delta.insertions], axis=0)
        weights = np.concatenate(
            [weights, delta.insert_weights.astype(weights.dtype)])
    return build_graph(edges, weights, n=n_new, device=graph.device)


def _edit_scripts(delta: GraphDelta, n_new: int) -> dict:
    """row -> {target: [ops]}, an op being an inserted weight or ``None``
    for a deletion; both directions of every edge."""
    edits: dict[int, dict[int, list]] = {}

    def ops(r: int, t: int) -> list:
        return edits.setdefault(r, {}).setdefault(t, [])

    for u, v in _live_deletions(delta, n_new).tolist():
        ops(u, v).append(None)
        ops(v, u).append(None)
    for (u, v), w in zip(delta.insertions.tolist(),
                         delta.insert_weights.tolist()):
        ops(u, v).append(w)
        ops(v, u).append(w)
    return edits


def apply_delta_patch(graph: Graph, delta: GraphDelta) -> Graph:
    """CSR splice with exactly :func:`apply_delta`'s bytes, without its
    sort: only the rows the delta touches are edited (dictionary splices),
    and the arrays are reassembled from bulk copies of the untouched runs.

    Byte parity with the rebuild:
    * weight merges add in float64 in the order ``build_graph`` adds
      duplicates (the existing edge first, then insertions in delta order),
      and a deletion applies before the insertions of the same edge;
    * ``kdeg`` sums the per-edge float64 values (not their float32 casts)
      in array order with ``np.bincount``, which accumulates sequentially
      in index order as ``build_graph`` does;
    * the fingerprint is computed from the new host arrays.
    The one exception: an empty delta that does not grow the graph returns
    the input graph object itself (a rebuild would re-round sum-merged
    duplicate weights through float32 and could move ``kdeg`` by an ulp).
    """
    n_old = graph.n
    n_new = _grown_n(n_old, delta)
    if delta.is_empty() and n_new == n_old:
        return graph

    m_old = graph.num_edges
    rp = graph.row_ptr.cpu().numpy()
    dst = graph.dst[:m_old].cpu().numpy()
    # float64 views of the stored float32 weights: exactly what a rebuild
    # reads back as its input
    w64 = graph.wgt[:m_old].cpu().numpy().astype(np.float64)

    new_rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for r, row_ops in _edit_scripts(delta, n_new).items():
        lo, hi = (int(rp[r]), int(rp[r + 1])) if r < n_old else (0, 0)
        cur = dict(zip(dst[lo:hi].tolist(), w64[lo:hi].tolist()))
        for tgt, ops in row_ops.items():
            ins = [w for w in ops if w is not None]
            if len(ins) < len(ops):     # a deletion drops the old edge
                cur.pop(tgt, None)
                acc = None
            else:
                acc = cur.get(tgt)
            for w in ins:               # float64, build_graph's add order
                acc = w if acc is None else acc + w
            if ins:
                cur[tgt] = acc
        order = sorted(cur)
        new_rows[r] = (np.array(order, dtype=np.int32),
                       np.array([cur[t] for t in order], dtype=np.float64))

    deg = np.zeros(n_new, dtype=np.int64)
    deg[:n_old] = rp[1:] - rp[:-1]
    for r, (rd, _) in new_rows.items():
        deg[r] = len(rd)
    row_ptr = np.zeros(n_new + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    dst_segs, w_segs = [], []
    pos = 0  # read position in the old arrays
    for r in sorted(new_rows):
        lo, hi = (int(rp[r]), int(rp[r + 1])) if r < n_old \
            else (m_old, m_old)
        rd, rw = new_rows[r]
        dst_segs += [dst[pos:lo], rd]
        w_segs += [w64[pos:lo], rw]
        pos = hi
    dst_segs.append(dst[pos:m_old])
    w_segs.append(w64[pos:m_old])
    dst_new = np.concatenate(dst_segs)
    w64_new = np.concatenate(w_segs)

    num_edges = len(dst_new)
    m_pad = max(_round_up(num_edges, _EDGE_ALIGN), _EDGE_ALIGN)
    src_pad = np.zeros(m_pad, dtype=np.int32)
    dst_pad = np.zeros(m_pad, dtype=np.int32)
    wgt_pad = np.zeros(m_pad, dtype=np.float32)
    mask = np.zeros(m_pad, dtype=bool)
    src_pad[:num_edges] = np.repeat(np.arange(n_new, dtype=np.int32), deg)
    dst_pad[:num_edges] = dst_new
    wgt_pad[:num_edges] = w64_new
    mask[:num_edges] = True
    kdeg = np.bincount(src_pad[:num_edges], weights=w64_new,
                       minlength=n_new)
    return graph_from_arrays(n_new, num_edges, row_ptr, src_pad, dst_pad,
                             wgt_pad, mask, kdeg.astype(np.float32),
                             device=graph.device)


def affected_frontier(delta: GraphDelta, n: int) -> np.ndarray:
    """(n,) bool mask of the vertices whose neighbourhoods the delta
    changed: the endpoints of every inserted or deleted edge.  Pass it as
    ``init_active`` together with warm labels."""
    out = np.zeros(n, dtype=bool)
    touched = delta.touched_vertices()
    out[touched[touched < n]] = True
    return out
