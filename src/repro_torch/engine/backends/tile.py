"""Tile backend: dense padded-neighbor tiles over the four LPA kernels.

The propagation loop mirrors ``core.lpa.lpa_run`` sweep for sweep (the same
hashed parity classes, per-sweep hash seeds ``2*it + sweep``, adopt rule and
float32 threshold) but computes each sweep with ``kernels.ops`` over
(rows, d) neighbor tiles: the CUDA kernels on the card, their plain versions
on the CPU.  With integer edge weights the per-community sums are exact in
float32, so labels and iteration counts equal the segment backend's.

With fusion on (``ops.resolve_fuse``) the loops take the *lazy-wake* form:
the wake of sub-sweep ``k`` is applied at the start of sub-sweep ``k+1``
from the carried changed mask, so each sub-sweep (and each split sweep) is
one ``fused_move`` (``fused_split``) launch.  Labels and iteration counts
are identical either way.  One scalar is read back per iteration for the
convergence test.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.graph import Graph, to_padded_neighbors
from repro_torch.core.lpa import threshold_for
from repro_torch.engine.bucketing import BucketKey, pad_active, pad_labels
from repro_torch.engine.cache import PLAN_LOG
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import (
    BackendRun,
    device_sync,
    register_backend,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import label_hash


def _propagate(plan, nbr, nw, nmask, n_real: int, labels, active):
    real = plan.ids < n_real
    threshold = threshold_for(plan.tau, plan.rows, n_real)
    active = active & real
    it, dn = 0, plan.rows
    while dn > threshold and it < plan.max_iterations:
        dn_t = torch.zeros((), dtype=torch.int64, device=plan.device)
        for sweep, klass in enumerate(plan.klasses):
            cand = active & klass
            best_lab, best_w, cur_w = ops.label_argmax(nbr, nw, nmask, labels,
                                                       2 * it + sweep)
            adopt = cand & (best_w > cur_w.clamp_min(0.0))
            new = torch.where(adopt, best_lab, labels)
            changed = new != labels
            wake = (changed[nbr] & nmask).any(dim=1)
            active = (active & ~cand) | (wake & real)
            labels = new
            dn_t += changed.sum()
        it += 1
        dn = int(dn_t)
    return labels, it


def _propagate_fused(plan, nbr, nw, nmask, n_real: int, labels, active):
    real = plan.ids < n_real
    threshold = threshold_for(plan.tau, plan.rows, n_real)
    active = active & real
    # chg / candp carry the previous sub-sweep's changed mask and candidate
    # set into the fused kernel, which refreshes the active set first.
    chg = torch.zeros(plan.rows, dtype=torch.bool, device=plan.device)
    candp = torch.zeros_like(chg)
    it, dn = 0, plan.rows
    while dn > threshold and it < plan.max_iterations:
        dn_t = torch.zeros((), dtype=torch.int64, device=plan.device)
        for sweep, klass in enumerate(plan.klasses):
            new, active = ops.fused_move(nbr, nw, nmask, labels, chg, active,
                                         candp, klass, real, 2 * it + sweep)
            chg = new != labels
            candp = active & klass
            labels = new
            dn_t += chg.sum()
        it += 1
        dn = int(dn_t)
    return labels, it


def _split(plan, nbr, nmask, comm):
    labels = plan.ids.clone()
    active = torch.ones(plan.rows, dtype=torch.bool, device=plan.device)
    same = ((comm[nbr] == comm[:, None]) & nmask) if plan.prune else None
    it, dn = 0, plan.rows
    while dn > 0:
        new = ops.min_label(nbr, nmask, labels, comm)
        if plan.prune:
            new = torch.where(active, new, labels)
        if plan.shortcut:
            new = torch.minimum(new, new[new])
        changed = new != labels
        if plan.prune:
            active = (changed[nbr] & same).any(dim=1)
        labels = new
        it += 1
        dn = int(changed.sum())
    return labels, it


def _split_fused(plan, nbr, nmask, comm):
    labels = plan.ids.clone()
    # ones on the first sweep: a row with no same-community neighbor
    # reduces to its own label, as the eager all-active start does.
    chg = torch.ones(plan.rows, dtype=torch.bool, device=plan.device)
    it, dn = 0, plan.rows
    while dn > 0:
        new = ops.fused_split(nbr, nmask, labels, comm, chg, plan.prune)
        if plan.shortcut:
            new = torch.minimum(new, new[new])
        chg = new != labels
        labels = new
        it += 1
        dn = int(chg.sum())
    return labels, it


@register_backend("tile")
class TileBackend:
    name = "tile"

    def plan_key(self, config: EngineConfig) -> tuple:
        return ()

    def build(self, bucket: BucketKey, config: EngineConfig,
              device: torch.device):
        fuse = ops.resolve_fuse(config.fuse_sweeps, device)
        do_split = config.split in ("lp", "lpp")
        PLAN_LOG.record("tile:propagate_fused" if fuse else "tile:propagate")
        if do_split:
            PLAN_LOG.record("tile:split_fused" if fuse else "tile:split")
        ids = torch.arange(bucket.n, dtype=torch.int32, device=device)
        parity = (label_hash(ids, -1) & 1).bool()
        return SimpleNamespace(
            rows=bucket.n, device=device, ids=ids,
            klasses=(~parity, parity), tau=config.tau,
            max_iterations=config.max_iterations, prune=config.split == "lpp",
            shortcut=config.shortcut,
            propagate=_propagate_fused if fuse else _propagate,
            split=(_split_fused if fuse else _split) if do_split else None)

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig):
        return to_padded_neighbors(graph, d_max=bucket.d, rows=bucket.n)

    def run(self, plan, inputs, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun:
        nbr, nw, nmask = inputs
        dev = plan.device
        labels0 = torch.from_numpy(pad_labels(
            np.arange(n_real, dtype=np.int32) if init_labels is None
            else init_labels, n_real, plan.rows)).to(dev)
        active0 = torch.from_numpy(
            pad_active(init_active, n_real, plan.rows)).to(dev)

        device_sync(dev)
        t0 = time.perf_counter()
        labels, lpa_iters = plan.propagate(plan, nbr, nw, nmask, n_real,
                                           labels0, active0)
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters = 0
        if plan.split is not None:
            labels, split_iters = plan.split(plan, nbr, nmask, labels)
        device_sync(dev)
        t2 = time.perf_counter()
        return BackendRun(labels=labels.cpu().numpy(),
                          lpa_iterations=lpa_iters,
                          split_iterations=split_iters,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1)
