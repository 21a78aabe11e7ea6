"""Dense padded-tile LPA path: the kernel-backed formulation.

``to_padded_neighbors`` lays each vertex's neighbor list out as a row of an
(n_pad, d_max) tile; ``lpa_move_dense`` then scores labels with the
``label_argmax`` kernel (B1: CUDA on the card, its plain version on the
CPU) and applies the adopt and prune rules of the sparse ``core.lpa`` path,
and ``split_lp_dense`` runs Split-Last's sweeps with ``min_label`` (B2).
Labels and iteration counts equal the sparse path's whenever the weights
are integers.

Unlike the engine's paths, ``lpa_run_dense`` takes its convergence
threshold as the truncated Python-float product ``int(tau * n)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import Graph, to_padded_neighbors
from repro_torch.kernels import ops
from repro_torch.kernels.ref import label_hash

__all__ = ["PaddedGraph", "lpa_move_dense", "lpa_run_dense",
           "neighbors_of_dense", "pad_graph", "split_lp_dense"]


@dataclasses.dataclass(frozen=True)
class PaddedGraph:
    n: int              # real vertex count
    n_pad: int          # tile rows (>= n); rows n.. are padding
    d_max: int          # tile width
    nbr: torch.Tensor   # (n_pad, d_max) int32 neighbor ids (self on padding)
    nw: torch.Tensor    # (n_pad, d_max) float32 weights (0 on padding)
    nmask: torch.Tensor  # (n_pad, d_max) bool


def pad_graph(graph: Graph, d_max: int | None = None,
              rows: int | None = None) -> PaddedGraph:
    """The graph's neighbor tiles on its device: ``d_max`` defaults to the
    maximum degree and ``rows`` to ``graph.n``."""
    nbr, nw, nmask = to_padded_neighbors(graph, d_max, rows)
    return PaddedGraph(n=graph.n, n_pad=nbr.shape[0], d_max=nbr.shape[1],
                       nbr=nbr, nw=nw, nmask=nmask)


def lpa_move_dense(pg: PaddedGraph, labels: torch.Tensor,
                   active: torch.Tensor, iteration: int):
    """Tile-path twin of ``core.lpa.lpa_move`` (labels padded to n_pad).

    Returns (new_labels, changed_mask, delta_n) with ``delta_n`` a 0-d
    tensor.
    """
    best_lab, best_w, cur_w = ops.label_argmax(pg.nbr, pg.nw, pg.nmask,
                                               labels, iteration)
    adopt = active & (best_w > cur_w.clamp_min(0.0))
    new_labels = torch.where(adopt, best_lab, labels)
    changed = new_labels != labels
    return new_labels, changed, changed.sum()


def neighbors_of_dense(pg: PaddedGraph, mask: torch.Tensor) -> torch.Tensor:
    """Rows having any real neighbor in ``mask`` (the pruning wake)."""
    return (mask[pg.nbr] & pg.nmask).any(dim=1)


def lpa_run_dense(pg: PaddedGraph, tau: float = 0.05,
                  max_iterations: int = 20) -> tuple[torch.Tensor, int]:
    """Semi-synchronous LPA on the tile path (mirrors ``core.lpa.lpa_run``).

    Returns (labels[:n], iterations).  One scalar is read back per
    iteration.
    """
    n_pad, n = pg.n_pad, pg.n
    dev = pg.nbr.device
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
    real = ids < n
    parity = (label_hash(ids, -1) & 1).bool()
    labels, active = ids.clone(), real.clone()
    threshold = int(tau * n)
    it, dn = 0, n
    while dn > threshold and it < max_iterations:
        dn_t = torch.zeros((), dtype=torch.int64, device=dev)
        for sweep, klass in enumerate((~parity, parity)):
            cand = active & klass & real
            labels, changed, d = lpa_move_dense(pg, labels, cand,
                                                2 * it + sweep)
            active = (active & ~cand) | (neighbors_of_dense(pg, changed)
                                         & real)
            dn_t += d
        it += 1
        # lint: host-sync-ok — one convergence scalar per iteration
        dn = int(dn_t)
    return labels[:n], it


def split_lp_dense(pg: PaddedGraph,
                   comm: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Tile-path SL-LP split: ``min_label`` sweeps to the fixpoint.

    Padding rows carry community -1.  No iteration cap; the count
    includes the last sweep, the one that changes nothing.  Returns
    (labels[:n], iterations).
    """
    n_pad, n = pg.n_pad, pg.n
    dev = pg.nbr.device
    comm_pad = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    comm_pad[:n] = comm.to(device=dev, dtype=torch.int32)
    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    it, dn = 0, 1
    while dn > 0:
        new = ops.min_label(pg.nbr, pg.nmask, labels, comm_pad)
        # lint: host-sync-ok — one changed count per sweep: the fixpoint test
        dn = int((new != labels).sum())
        labels = new
        it += 1
    return labels[:n], it
