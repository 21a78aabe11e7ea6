"""Multi-graph batching: disjoint-union packing + batched LPA / split.

GSL-LPA's labels are vertex ids and label propagation never crosses a
missing edge, so k graphs packed as a *disjoint union* (concatenated CSR
arrays with per-graph vertex-id offsets and no inter-graph edges)
propagate independently in the same launches.

Exact per-graph parity with ``Engine.fit`` needs care in two places:

* **Local label coordinates.**  The tie-break hash and the parity classes
  are functions of raw label and vertex-id values, so every vertex's label
  stays in its graph's *local* id space (values in ``[0, n_i)``) while
  gathers use global rows; ``voffset`` (each row's owner offset) converts
  between the two where needed (the split shortcut's pointer jump).
* **Per-graph convergence.**  Each member stops where its solo run would:
  the loops keep a per-graph ``done`` flag (a done graph offers no
  candidates) and per-graph iteration counts, and go on until every member
  has converged.  Converged members ride along as no-ops: their labels are
  at a sweep fixpoint.

Each loop reads one ``done`` vector per iteration on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.lpa import (
    label_hash,
    lpa_move,
    neighbors_of,
    segment_sum,
)
from repro_torch.core.split import _min_label_sweep
from repro_torch.obs.convergence import (
    empty_batch_profile_buffer,
    record_row,
)

__all__ = ["GraphBatch", "batch_thresholds", "lpa_run_batched",
           "split_lp_batched", "warm_state_rows"]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """k graphs packed into one disjoint-union super-graph.

    ``graph`` is a normal :class:`Graph` (member edge padding stripped, no
    padded tail), so every single-graph path (bucketing, ``pad_graph``,
    ``to_padded_neighbors``) applies unchanged.  The batch metadata stays
    host-side numpy.
    """
    graph: Graph             # packed super-graph (no inter-graph edges)
    sizes: np.ndarray        # (k,) int64 per-graph vertex counts
    offsets: np.ndarray      # (k + 1,) int64 vertex-id offset per graph
    edge_counts: np.ndarray  # (k,) int64 per-graph directed edge counts
    graph_id: np.ndarray     # (total_vertices,) int32 owner of each vertex

    @property
    def num_graphs(self) -> int:
        return len(self.sizes)

    @property
    def total_vertices(self) -> int:
        return int(self.offsets[-1])

    @property
    def total_edges(self) -> int:
        return int(self.edge_counts.sum())

    @classmethod
    def pack(cls, graphs, device="cpu") -> "GraphBatch":
        """Disjoint-union pack: offset vertex ids, concatenate CSR arrays.

        Each member's edges are sorted by (src, dst) and the offsets
        increase, so the concatenation is a valid CSR ordering.  Handles
        empty and edgeless members.  The packed graph's tensors live on
        ``device``; its edge arrays are exactly ``total_edges`` long.
        """
        graphs = list(graphs)
        if not graphs:
            raise ValueError("GraphBatch.pack needs at least one graph")
        sizes = np.array([g.n for g in graphs], dtype=np.int64)
        offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(sizes)])
        edge_counts = np.array([g.num_edges for g in graphs], dtype=np.int64)
        edge_base = np.concatenate([np.zeros(1, np.int64),
                                    np.cumsum(edge_counts)])
        # Each member goes to ``device`` as it is (a host member is
        # uploaded once, a member already there is not copied) and the
        # offsets are added there, in int32.
        dev = torch.device(device)
        parts: dict[str, list] = {"row_ptr": [torch.zeros(
            1, dtype=torch.int32, device=dev)], "src": [], "dst": [],
            "wgt": [], "kdeg": []}
        for g, off, base in zip(graphs, offsets[:-1], edge_base[:-1]):
            e = g.num_edges
            parts["src"].append(g.src[:e].to(dev) + int(off))
            parts["dst"].append(g.dst[:e].to(dev) + int(off))
            parts["wgt"].append(g.wgt[:e].to(dev))
            parts["kdeg"].append(g.kdeg.to(dev))
            parts["row_ptr"].append(g.row_ptr[1:].to(dev) + int(base))
        m = int(edge_base[-1])
        packed = Graph(n=int(offsets[-1]), m_pad=m, num_edges=m,
                       edge_mask=torch.ones(m, dtype=torch.bool, device=dev),
                       **{k: torch.cat(v) for k, v in parts.items()})
        graph_id = np.repeat(np.arange(len(graphs), dtype=np.int32), sizes)
        return cls(graph=packed, sizes=sizes, offsets=offsets,
                   edge_counts=edge_counts, graph_id=graph_id)

    def vertex_offsets(self) -> np.ndarray:
        """(total_vertices,) int32: each vertex's owning-graph offset."""
        return np.repeat(self.offsets[:-1].astype(np.int32), self.sizes)

    def pack_labels(self, member_labels) -> np.ndarray | None:
        """Concatenate per-member init labels into one packed vector.

        ``member_labels`` has one entry per graph: an (n_i,) vertex-id
        valued array (local coordinates: a solo graph's ids are its local
        ids) or None for a cold member (singleton start).  Returns a
        (total_vertices,) int32 vector, or None when every member is cold.
        """
        member_labels = list(member_labels)
        if len(member_labels) != self.num_graphs:
            raise ValueError(f"got {len(member_labels)} init-label entries "
                             f"for a batch of {self.num_graphs} graphs")
        if all(lab is None for lab in member_labels):
            return None
        out = np.empty(self.total_vertices, dtype=np.int32)
        for i, lab in enumerate(member_labels):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            if lab is None:
                out[lo:hi] = np.arange(hi - lo, dtype=np.int32)
            else:
                out[lo:hi] = np.asarray(lab, dtype=np.int32).reshape(-1)
        return out

    def pack_active(self, member_active) -> np.ndarray | None:
        """Concatenate per-member init active masks (None: all active).

        Returns a (total_vertices,) bool vector, or None when every member
        is fully active.
        """
        member_active = list(member_active)
        if len(member_active) != self.num_graphs:
            raise ValueError(f"got {len(member_active)} init-active entries "
                             f"for a batch of {self.num_graphs} graphs")
        if all(act is None for act in member_active):
            return None
        out = np.empty(self.total_vertices, dtype=bool)
        for i, act in enumerate(member_active):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            out[lo:hi] = True if act is None \
                else np.asarray(act, dtype=bool).reshape(-1)
        return out

    def unpack(self, labels, compact: bool = True) -> list[np.ndarray]:
        """Slice a packed (>= total_vertices,) local-label vector per graph;
        with ``compact`` each slice is relabeled to ``[0, K_i)`` in the rank
        order of its values, as the engine's compaction does."""
        labels = np.asarray(labels).reshape(-1)
        if len(labels) < self.total_vertices:
            raise ValueError(f"labels has {len(labels)} entries; batch has "
                             f"{self.total_vertices} vertices")
        out = []
        for i in range(self.num_graphs):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            lab = labels[lo:hi].astype(np.int32)
            if compact:
                lab = np.unique(lab, return_inverse=True)[1].astype(
                    np.int32).reshape(-1)
            out.append(lab)
        return out


def warm_state_rows(rows: int, voffset, labels0=None, active0=None,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Extend packed (total_vertices,) warm-start state to ``rows`` rows.

    Bucket-padding rows keep their local singleton ids (``row -
    voffset``, the cold start) and are seeded inactive when an explicit
    active mask is given.  With both inputs None this is the cold default:
    local-id labels, all active.
    """
    local = np.arange(rows, dtype=np.int32) - np.asarray(voffset, np.int32)
    if labels0 is None:
        lab = local
    else:
        lab = local.copy()
        lab[: len(labels0)] = np.asarray(labels0, dtype=np.int32)
    if active0 is None:
        act = np.ones(rows, dtype=bool)
    else:
        act = np.zeros(rows, dtype=bool)
        act[: len(active0)] = np.asarray(active0, dtype=bool)
    return lab, act


def batch_thresholds(tau: float, sizes: np.ndarray) -> np.ndarray:
    """Per-slot convergence thresholds ``int32(float32(tau) *
    float32(size))``, under every bucketing."""
    return (np.float32(tau) * np.asarray(sizes).astype(np.float32)
            ).astype(np.int32)


def lpa_run_batched(graph: Graph, sizes: np.ndarray, graph_id: torch.Tensor,
                    voffset: torch.Tensor, labels0: torch.Tensor,
                    active0: torch.Tensor, *, tau: float,
                    max_iterations: int, profile: bool = False):
    """Batched propagation over a packed, bucket-padded graph.

    sizes: (k1,) host per-slot real vertex counts (0 for empty slots and
      the padding slot).
    graph_id / voffset: (graph.n,) int32 owner slot and owner offset of
      each row on the device; ``graph_id`` is non-decreasing.
    labels0 / active0: (graph.n,) initial labels in *local* coordinates
      and unprocessed-seed mask.

    Returns (labels in local coordinates, per-slot iteration counts): each
    slot stops where its solo ``lpa_run`` would (the same float32
    threshold, hash seeds and parity classes of local ids).

    ``profile``: also fill a ``(2 * max_iterations, 2, k1)`` int32 buffer
    on the device with per-slot [candidate count, changed count] per
    sub-sweep (exact integer segment sums), and return
    ``(labels, iterations, buffer)``.
    """
    n = graph.n
    dev = graph.device
    k1 = len(sizes)
    local = torch.arange(n, dtype=torch.int32, device=dev) - voffset
    parity = (label_hash(local, -1) & 1).bool()
    thr_h = batch_thresholds(tau, sizes)
    thr = torch.from_numpy(thr_h).to(dev)
    done_h = np.asarray(sizes) <= thr_h
    done = torch.from_numpy(done_h).to(dev)
    iters = np.zeros(k1, np.int32)
    labels, active = labels0.to(torch.int32), active0.to(torch.bool)
    buf = empty_batch_profile_buffer(2 * max_iterations, k1, dev) \
        if profile else None
    it = 0
    while not done_h.all() and it < max_iterations:
        running = ~done[graph_id]
        dn = torch.zeros(k1, dtype=torch.int64, device=dev)
        for sweep, klass in enumerate((~parity, parity)):
            cand = active & klass & running
            labels, changed, _ = lpa_move(graph, labels, cand, 2 * it + sweep)
            active = (active & ~cand) | neighbors_of(graph, changed)
            sc = segment_sum(changed, graph_id, k1, sorted_ids=True)
            dn += sc
            if buf is not None:
                record_row(buf, 2 * it + sweep, segment_sum(
                    cand, graph_id, k1, sorted_ids=True), sc, 2 * it + sweep)
        iters += ~done_h
        done = done | (dn <= thr)
        # lint: host-sync-ok — one per-slot done vector per iteration
        done_h = done.cpu().numpy()
        it += 1
    return (labels, iters, buf) if profile else (labels, iters)


def split_lp_batched(graph: Graph, sizes: np.ndarray, graph_id: torch.Tensor,
                     voffset: torch.Tensor, comm: torch.Tensor, *,
                     prune: bool = False, shortcut: bool = False,
                     profile_rows: int = 0):
    """Batched Split-Last over a packed graph (local-label coordinates).

    Min-label sweeps are idempotent at a member's fixpoint, so converged
    members stop changing while the loop drains the rest; per-slot
    iteration counts record the sweep at which each member's solo
    ``split_lp`` would have stopped.

    ``profile_rows`` (0 = off): also fill a ``(profile_rows, 2, k1)``
    int32 per-slot [active count, changed count] buffer per sweep (rows
    past the cap overwrite the last) and return
    ``(labels, iterations, buffer)``.
    """
    n = graph.n
    dev = graph.device
    k1 = len(sizes)
    comm = comm.to(torch.int32)
    labels = torch.arange(n, dtype=torch.int32, device=dev) - voffset
    active = torch.ones(n, dtype=torch.bool, device=dev)
    done_h = np.asarray(sizes) == 0
    done = torch.from_numpy(done_h).to(dev)
    iters = np.zeros(k1, np.int32)
    buf = empty_batch_profile_buffer(profile_rows, k1, dev) \
        if profile_rows else None
    it = 0
    while not done_h.all():
        prev_active = active
        labels, active, changed, _ = _min_label_sweep(
            graph, comm, labels, active, prune, shortcut, voffset=voffset)
        dn = segment_sum(changed, graph_id, k1, sorted_ids=True)
        if buf is not None:
            record_row(buf, min(it, profile_rows - 1), segment_sum(
                prev_active, graph_id, k1, sorted_ids=True), dn, it)
        iters += ~done_h
        done = done | (dn == 0)
        # lint: host-sync-ok — one per-slot done vector per sweep
        done_h = done.cpu().numpy()
        it += 1
    return (labels, iters, buf) if profile_rows else (labels, iters)
