"""The paper's §4.1 preprocessing pipeline as composable host passes.

Every graph in the paper's evaluation corpus is made undirected,
unit-weighted, and loop/duplicate-free before detection: *"we ensure
all edges are undirected and weighted with a weight of 1"*.  This
module expresses that as a sequence of pure numpy passes over a raw
:class:`repro_torch.io.formats.EdgeList`:

  ``canonicalize``       (u, v) -> (min, max): an undirected edge has one
                         identity regardless of storage direction.
  ``drop_self_loops``    remove u == u rows (``scanCommunities``
                         excludes i == j; ``build_graph`` would drop
                         them anyway, but dropping here makes the
                         stats report them).
  ``dedup``              collapse duplicate undirected edges, keeping
                         the **max** weight — the SuiteSparse corpus
                         stores some matrices with both triangles or
                         repeated entries; max (not sum) keeps a
                         re-stored edge from doubling its weight.
  ``unit_weights``       drop weights entirely (paper default).
  ``largest_component``  optional: restrict to the largest connected
                         component (some corpora evaluate on the LCC).
  ``compact_ids``        optional: dense-relabel the vertex ids that
                         actually appear (SNAP files often have sparse
                         id spaces); implied by ``largest_component``.

:func:`preprocess` runs the passes in that order and returns the
cleaned edge list plus a :class:`PreprocessStats` with before/after
counts per pass — the raw vs. post-dedup |E| columns in the Table-1
report come straight from it.

The cleaned output feeds ``build_graph`` directly.  After ``dedup``
there are no duplicate undirected edges, so ``build_graph``'s
sum-merge of duplicates is vacuously a no-op and the resulting CSR is
bit-identical to building from a hand-cleaned list — the contract the
round-trip tests pin.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.io.formats import EdgeList


@dataclasses.dataclass(frozen=True)
class PreprocessOptions:
    """Knobs for :func:`preprocess` (all of §4.1, individually gateable).

    The defaults reproduce the paper's setup exactly: symmetrized,
    deduplicated, loop-free, unit weights, full vertex set.
    """
    drop_self_loops: bool = True
    dedup: bool = True
    unit_weights: bool = True
    largest_component: bool = False
    compact_ids: bool = False

    def cache_token(self) -> str:
        """Stable string identity for on-disk cache keys."""
        return (f"loops{int(self.drop_self_loops)}-dedup{int(self.dedup)}-"
                f"unit{int(self.unit_weights)}-"
                f"lcc{int(self.largest_component)}-"
                f"compact{int(self.compact_ids)}")


@dataclasses.dataclass
class PreprocessStats:
    """Before/after counts for each pass (the §4.1 report card)."""
    raw_edges: int = 0            # rows in the file (post storage expansion)
    raw_vertices: int = 0
    self_loops: int = 0           # rows removed as u == u
    duplicates: int = 0           # rows collapsed by dedup
    edges: int = 0                # undirected edges after cleaning
    vertices: int = 0             # vertex count after compaction (if any)
    isolated_vertices: int = 0    # ids in range that touch no edge
    component_vertices_dropped: int = 0  # LCC extraction removals
    weighted: bool = False        # cleaned list still carries weights

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def canonicalize(edges: np.ndarray) -> np.ndarray:
    """(E, 2) -> (E, 2) with u <= v per row (undirected identity)."""
    return np.stack([edges.min(axis=1), edges.max(axis=1)], axis=1)


def dedup_max_weight(edges: np.ndarray, weights: np.ndarray | None,
                     n: int) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Collapse duplicate canonical edges, keeping the max weight.

    Returns (edges, weights, duplicates_removed); output is sorted by
    (u, v) — the order ``build_graph`` would sort into anyway.
    """
    if not len(edges):
        return edges, weights, 0
    key = edges[:, 0] * np.int64(n) + edges[:, 1]
    if weights is None:
        uniq = np.unique(key)
        out = np.stack([uniq // n, uniq % n], axis=1)
        return out, None, len(edges) - len(uniq)
    uniq, inv = np.unique(key, return_inverse=True)
    wmax = np.full(len(uniq), -np.inf, dtype=np.float64)
    np.maximum.at(wmax, inv, weights)
    out = np.stack([uniq // n, uniq % n], axis=1)
    return out, wmax, len(edges) - len(uniq)


def connected_components(edges: np.ndarray, n: int) -> np.ndarray:
    """(n,) component id per vertex via vectorized label shrinking.

    Pointer-jumping union over the undirected edge set: every vertex
    repeatedly adopts the minimum label in its neighborhood closure.
    O((n + E) * iterations) with numpy-level passes; iterations is the
    component diameter in the worst case but collapses fast in practice
    thanks to the path-halving jump.
    """
    labels = np.arange(n, dtype=np.int64)
    if not len(edges):
        return labels
    u, v = edges[:, 0], edges[:, 1]
    while True:
        before = labels
        # edge relaxation: both endpoints adopt the pair's min label
        m = np.minimum(labels[u], labels[v])
        labels = labels.copy()
        np.minimum.at(labels, u, m)
        np.minimum.at(labels, v, m)
        # path halving: jump each label to its label's label
        labels = labels[labels]
        if np.array_equal(labels, before):
            # fixed point: every edge has equal endpoint labels (else the
            # relaxation would have lowered one) == per-component minima
            return labels


def largest_component_mask(edges: np.ndarray, n: int) -> np.ndarray:
    """(n,) bool mask of the largest connected component's vertices.

    Isolated vertices are singleton components; ties break toward the
    smallest root id (deterministic).
    """
    comp = connected_components(edges, n)
    roots, counts = np.unique(comp, return_counts=True)
    return comp == roots[np.argmax(counts)]


def preprocess(raw: EdgeList, opts: PreprocessOptions | None = None,
               ) -> tuple[EdgeList, PreprocessStats]:
    """Run the §4.1 pipeline; returns (cleaned EdgeList, stats)."""
    opts = opts or PreprocessOptions()
    edges = np.asarray(raw.edges, dtype=np.int64).reshape(-1, 2)
    weights = None if raw.weights is None \
        else np.asarray(raw.weights, dtype=np.float64).reshape(-1)
    n = int(raw.n)
    stats = PreprocessStats(raw_edges=len(edges), raw_vertices=n)

    edges = canonicalize(edges)

    if opts.drop_self_loops:
        keep = edges[:, 0] != edges[:, 1]
        stats.self_loops = int((~keep).sum())
        edges = edges[keep]
        if weights is not None:
            weights = weights[keep]

    if opts.dedup:
        edges, weights, stats.duplicates = dedup_max_weight(edges, weights, n)

    if opts.unit_weights:
        weights = None

    def _touched(e: np.ndarray) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        if len(e):
            out[e[:, 0]] = True
            out[e[:, 1]] = True
        return out

    # Isolated count reflects the *cleaned* graph, before any LCC
    # extraction — off-LCC vertices must not re-count as "isolated"
    # just because their edges were removed (they are already reported
    # in component_vertices_dropped, which includes isolated singletons).
    touched = _touched(edges)
    stats.isolated_vertices = int(n - touched.sum())

    if opts.largest_component:
        mask = largest_component_mask(edges, n)
        stats.component_vertices_dropped = int((~mask).sum())
        keep = mask[edges[:, 0]] & mask[edges[:, 1]]
        edges = edges[keep]
        if weights is not None:
            weights = weights[keep]
        touched = _touched(edges)

    if opts.compact_ids or opts.largest_component:
        # Dense-relabel the surviving vertex ids.  After LCC extraction
        # the dropped vertices must not linger as isolated singletons —
        # they would show up as spurious size-1 communities.
        keep_ids = np.flatnonzero(touched)
        remap = -np.ones(n, dtype=np.int64)
        remap[keep_ids] = np.arange(len(keep_ids))
        edges = remap[edges]
        n = int(len(keep_ids))

    stats.edges = len(edges)
    stats.vertices = n
    stats.weighted = weights is not None
    meta = dict(raw.meta)
    meta["preprocess"] = opts.cache_token()
    return EdgeList(edges=edges, weights=weights, n=n, meta=meta), stats
