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

The batched trio runs the same kernels over a packed disjoint union of
graphs (``core.batch``), reading one per-slot ``done`` vector per
iteration.  The partition hooks run one out-of-core partition visit each
(:mod:`repro_torch.partition.ooc`): B1 / B2 unfused, B3 / B4 fused, on the
partition's owned-row tiles and its ``[owned; halo]`` label vectors.

Profiling (``EngineConfig.profile``): each loop takes an optional buffer
on the device and writes one row per sub-sweep (split sweep) into it with
``obs.convergence.record_row``: the row index is a Python int, the counts
stay device tensors, so no host read is added.  Propagation records the
sub-sweep's candidate set; the unfused split its ``active & real`` rows,
the fused split its wake source ``chg & real`` (it never builds the prune
worklist), as the JAX engine does.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.batch import batch_thresholds, warm_state_rows
from repro_torch.core.graph import Graph, to_padded_neighbors
from repro_torch.core.lpa import segment_sum, threshold_for
from repro_torch.engine.bucketing import (
    BatchBucketKey,
    BucketKey,
    pad_active,
    pad_labels,
)
from repro_torch.engine.cache import PLAN_LOG
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import (
    BackendRun,
    BatchBackendRun,
    BatchIndex,
    batch_index,
    device_sync,
    pad_to_device,
    profile_plan,
    register_backend,
    to_device,
    to_host,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import label_hash
from repro_torch.obs.convergence import (
    batch_profiles,
    count_true,
    empty_batch_profile_buffer,
    empty_profile_buffer,
    record_row,
    solo_profile,
)


def _propagate(plan, nbr, nw, nmask, n_real: int, labels, active,
               buf=None):
    real = plan.ids < n_real
    threshold = threshold_for(plan.tau, plan.rows, n_real)
    active = active & real
    it, dn = 0, plan.rows
    while dn > threshold and it < plan.max_iterations:
        dn_t = torch.zeros((), dtype=torch.int64, device=plan.device)
        for sweep, klass in enumerate(plan.klasses):
            seed = 2 * it + sweep
            cand = active & klass
            best_lab, best_w, cur_w = ops.label_argmax(nbr, nw, nmask, labels,
                                                       seed)
            adopt = cand & (best_w > cur_w.clamp_min(0.0))
            new = torch.where(adopt, best_lab, labels)
            changed = new != labels
            wake = (changed[nbr] & nmask).any(dim=1)
            active = (active & ~cand) | (wake & real)
            labels = new
            sc = changed.sum()
            dn_t += sc
            if buf is not None:
                record_row(buf, seed, count_true(cand), sc, seed)
        it += 1
        dn = int(dn_t)
    return labels, it


def _propagate_fused(plan, nbr, nw, nmask, n_real: int, labels, active,
                     buf=None):
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
            seed = 2 * it + sweep
            new, active = ops.fused_move(nbr, nw, nmask, labels, chg, active,
                                         candp, klass, real, seed)
            chg = new != labels
            # this sub-sweep's candidate set: the unfused loop's cand
            candp = active & klass
            labels = new
            sc = chg.sum()
            dn_t += sc
            if buf is not None:
                record_row(buf, seed, count_true(candp), sc, seed)
        it += 1
        dn = int(dn_t)
    return labels, it


def _split(plan, nbr, nmask, comm, n_real: int, buf=None):
    labels = plan.ids.clone()
    real = plan.ids < n_real if buf is not None else None
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
        sc = changed.sum()
        if buf is not None:
            record_row(buf, min(it, len(buf) - 1),
                       count_true(active & real), sc, it)
        if plan.prune:
            active = (changed[nbr] & same).any(dim=1)
        labels = new
        it += 1
        dn = int(sc)
    return labels, it


def _split_fused(plan, nbr, nmask, comm, n_real: int, buf=None):
    labels = plan.ids.clone()
    real = plan.ids < n_real if buf is not None else None
    # ones on the first sweep: a row with no same-community neighbor
    # reduces to its own label, as the eager all-active start does.
    chg = torch.ones(plan.rows, dtype=torch.bool, device=plan.device)
    it, dn = 0, plan.rows
    while dn > 0:
        new = ops.fused_split(nbr, nmask, labels, comm, chg, plan.prune)
        if plan.shortcut:
            new = torch.minimum(new, new[new])
        changed = new != labels
        sc = changed.sum()
        if buf is not None:
            # the wake source stands in for the worklist the kernel folds
            record_row(buf, min(it, len(buf) - 1), count_true(chg & real),
                       sc, it)
        chg = changed
        labels = new
        it += 1
        dn = int(sc)
    return labels, it


# --- batched loops: one launch per sub-sweep over the packed rows.  Labels
# live in per-graph *local* coordinates (the argmax tie-break hashes raw
# label values) while nbr holds global rows; per-slot done flags freeze
# each member where its solo run would stop, and each slot's changed count
# is an exact integer segment sum over graph_id.

def _propagate_batch(plan, nbr, nw, nmask, b: BatchIndex, labels, active,
                     buf=None):
    dev = plan.device
    k1 = len(b.sizes)
    local = plan.ids - b.voffset
    parity = (label_hash(local, -1) & 1).bool()
    real = plan.ids < b.n_total
    thr_h = batch_thresholds(plan.tau, b.sizes)
    thr = torch.from_numpy(thr_h).to(dev)
    done_h = b.sizes <= thr_h
    done = torch.from_numpy(done_h).to(dev)
    iters = np.zeros(k1, np.int32)
    active = active & real
    # fused: chg / candp carry the previous sub-sweep's changed mask and
    # candidate set into the kernel, which applies the wake first
    chg = torch.zeros(plan.rows, dtype=torch.bool, device=dev)
    candp = torch.zeros_like(chg)
    it = 0
    while not done_h.all() and it < plan.max_iterations:
        running = ~done[b.graph_id]
        dn = torch.zeros(k1, dtype=torch.int64, device=dev)
        for sweep, klass in enumerate((~parity, parity)):
            seed = 2 * it + sweep
            if plan.fuse:
                new, active = ops.fused_move(nbr, nw, nmask, labels, chg,
                                             active, candp, klass & running,
                                             real, seed)
                cand = candp = active & klass & running
                chg = new != labels
            else:
                cand = active & klass & running
                best_lab, best_w, cur_w = ops.label_argmax(nbr, nw, nmask,
                                                           labels, seed)
                adopt = cand & (best_w > cur_w.clamp_min(0.0))
                new = torch.where(adopt, best_lab, labels)
                chg = new != labels
                wake = (chg[nbr] & nmask).any(dim=1)
                active = (active & ~cand) | (wake & real)
            labels = new
            sc = segment_sum(chg, b.graph_id, k1, sorted_ids=True)
            dn += sc
            if buf is not None:
                record_row(buf, seed, segment_sum(cand, b.graph_id, k1,
                                                  sorted_ids=True), sc, seed)
        iters += ~done_h
        done = done | (dn <= thr)
        done_h = done.cpu().numpy()
        it += 1
    return labels, iters


def _split_batch(plan, nbr, nmask, b: BatchIndex, comm, buf=None):
    dev = plan.device
    k1 = len(b.sizes)
    labels = plan.ids - b.voffset
    # fused: last sweep's changed mask, ones on the first (see _split_fused)
    chg = torch.ones(plan.rows, dtype=torch.bool, device=dev)
    # unfused with prune: the rows to sweep, and the same-community cells
    active = torch.ones_like(chg)
    same = ((comm[nbr] == comm[:, None]) & nmask) \
        if plan.prune and not plan.fuse else None
    done_h = b.sizes == 0
    done = torch.from_numpy(done_h).to(dev)
    iters = np.zeros(k1, np.int32)
    it = 0
    while not done_h.all():
        if plan.fuse:
            new = ops.fused_split(nbr, nmask, labels, comm, chg, plan.prune)
        else:
            new = ops.min_label(nbr, nmask, labels, comm)
            if plan.prune:
                new = torch.where(active, new, labels)
        if plan.shortcut:
            new = torch.minimum(new, new[new + b.voffset])
        changed = new != labels
        dn = segment_sum(changed, b.graph_id, k1, sorted_ids=True)
        if buf is not None:
            # fused: the wake source (last sweep's chg) as the frontier
            record_row(buf, min(it, len(buf) - 1), segment_sum(
                chg if plan.fuse else active, b.graph_id, k1,
                sorted_ids=True), dn, it)
        chg = changed
        if same is not None:
            active = (chg[nbr] & same).any(dim=1)
        labels = new
        iters += ~done_h
        done = done | (dn == 0)
        done_h = done.cpu().numpy()
        it += 1
    return labels, iters


@register_backend("tile")
class TileBackend:
    name = "tile"
    supports_batch = True
    supports_partition = True

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
            split=(_split_fused if fuse else _split) if do_split else None,
            **profile_plan(config, do_split))

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig):
        return to_padded_neighbors(graph, d_max=bucket.d, rows=bucket.n)

    def run(self, plan, inputs, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun:
        nbr, nw, nmask = inputs
        dev = plan.device
        labels0 = to_device(
            np.arange(plan.rows, dtype=np.int32) if init_labels is None
            else pad_labels(init_labels, n_real, plan.rows), dev)
        active0 = to_device(pad_active(init_active, n_real, plan.rows), dev)

        pbuf = empty_profile_buffer(2 * plan.max_iterations, dev) \
            if plan.profile else None
        sbuf = empty_profile_buffer(plan.split_rows, dev) \
            if plan.split_rows and plan.split is not None else None

        device_sync(dev)
        t0 = time.perf_counter()
        labels, lpa_iters = plan.propagate(plan, nbr, nw, nmask, n_real,
                                           labels0, active0, pbuf)
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters = 0
        if plan.split is not None:
            labels, split_iters = plan.split(plan, nbr, nmask, labels,
                                             n_real, sbuf)
        device_sync(dev)
        t2 = time.perf_counter()
        labels, pbuf, sbuf = to_host(labels, n_real, pbuf, sbuf)
        profile = solo_profile(pbuf, lpa_iters, sbuf, split_iters,
                               plan.split_rows, n_real) \
            if plan.profile else None
        return BackendRun(labels=labels, lpa_iterations=lpa_iters,
                          split_iterations=split_iters,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1,
                          profile=profile)

    # --- batched dispatch (GraphBatch disjoint-union packing) ---

    def build_batch(self, bucket: BatchBucketKey, config: EngineConfig,
                    device: torch.device):
        fuse = ops.resolve_fuse(config.fuse_sweeps, device)
        do_split = config.split in ("lp", "lpp")
        PLAN_LOG.record("tile:batch_propagate_fused" if fuse
                        else "tile:batch_propagate")
        if do_split:
            PLAN_LOG.record("tile:batch_split_fused" if fuse
                            else "tile:batch_split")
        return SimpleNamespace(
            rows=bucket.n, device=device, fuse=fuse, do_split=do_split,
            ids=torch.arange(bucket.n, dtype=torch.int32, device=device),
            tau=config.tau, max_iterations=config.max_iterations,
            prune=config.split == "lpp", shortcut=config.shortcut,
            **profile_plan(config, do_split))

    def prepare_batch(self, batch, bucket: BatchBucketKey,
                      config: EngineConfig):
        g = batch.graph
        return (to_padded_neighbors(g, d_max=bucket.d, rows=bucket.n),
                batch_index(batch, bucket.k, bucket.n, g.device))

    def run_batch(self, plan, inputs,
                  init_labels: np.ndarray | None = None,
                  init_active: np.ndarray | None = None) -> BatchBackendRun:
        (nbr, nw, nmask), b = inputs
        dev = plan.device
        lab0, act0 = warm_state_rows(plan.rows, b.voffset_host, init_labels,
                                     init_active)
        labels0, active0 = to_device(lab0, dev), to_device(act0, dev)

        k1 = len(b.sizes)
        pbuf = empty_batch_profile_buffer(2 * plan.max_iterations, k1, dev) \
            if plan.profile else None
        sbuf = empty_batch_profile_buffer(plan.split_rows, k1, dev) \
            if plan.split_rows else None

        device_sync(dev)
        t0 = time.perf_counter()
        labels, iters = _propagate_batch(plan, nbr, nw, nmask, b, labels0,
                                         active0, pbuf)
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters = np.zeros(k1, np.int32)
        if plan.do_split:
            labels, split_iters = _split_batch(plan, nbr, nmask, b, labels,
                                               sbuf)
        device_sync(dev)
        t2 = time.perf_counter()
        labels, pbuf, sbuf = to_host(labels, b.n_total, pbuf, sbuf)
        profiles = batch_profiles(pbuf, iters, sbuf, split_iters,
                                  plan.split_rows, b.sizes) \
            if plan.profile else None
        return BatchBackendRun(labels=labels, lpa_iterations=iters,
                               split_iterations=split_iters,
                               lpa_seconds=t1 - t0, split_seconds=t2 - t1,
                               profile=profiles)

    # --- out-of-core partition sweeps (repro_torch.partition.ooc) ---
    #
    # A partition's tiles hold only its *owned* rows (``shapes.rows``
    # high), but neighbor ids index the whole local row space (owned +
    # halo), and the kernels gather ``labels`` / ``comm`` / ``chg`` through
    # ``nbr`` from vectors longer than the tile, so the halo imports need
    # no copy into the tile.  Label values are global vertex ids: the
    # argmax hash is a function of the raw value and the kernels' sentinel
    # is INT32_MAX, so ``bound`` is not needed here.  The tile width is the
    # in-core degree bucket, so a row is folded at the in-core width and
    # slot order.  Owned-row state comes in as host arrays, padded to the
    # tile rows and uploaded; results stay on the device.

    def build_partition(self, config: EngineConfig, device: torch.device):
        fuse = ops.resolve_fuse(config.fuse_sweeps, device)
        PLAN_LOG.record("tile:partition_fused" if fuse else "tile:partition")
        return SimpleNamespace(device=device, prune=config.split == "lpp",
                               fuse=fuse)

    def partition_caps(self, budget: int, d_bucket: int):
        """(max_edges, max_vertices) per partition for a byte budget.

        The port's own sizing for its tiles: 9 B per cell (nbr, weight,
        mask) at ``d_bucket`` cells per row, rows padded to a power of two
        (at most 2x), and ~12 B/edge of window.  The JAX engine pads the
        width to 128 lanes, a TPU layout this port does not carry, so for
        one budget the two may cut a different number of partitions; the
        labels are the same either way.  Halving the budget leaves room
        for the staged window and the label caches.
        """
        half = max(budget // 2, 1)
        return max(half // 40, 1), max(half // (18 * max(d_bucket, 1)), 8)

    def partition_prepare_nbytes(self, shapes) -> int:
        return shapes.rows * shapes.d * 9

    def prepare_partition(self, resident, shapes, config: EngineConfig,
                          device: torch.device):
        """Dense (rows, d) neighbor tiles of one partition's owned rows,
        built on ``device`` from the uploaded window.

        The padding of ``to_padded_neighbors`` (self-pointing ids, zero
        weight, masked out), one scatter.  The tiles are fresh
        allocations, never views of a larger tile: the kernels take only
        16-byte aligned tiles.
        """
        rows, d = shapes.rows, shapes.d
        size, m_w = resident.size, len(resident.dst)
        nbr = torch.arange(rows, dtype=torch.int32,
                           device=device)[:, None].repeat(1, d)
        nw = torch.zeros((rows, d), dtype=torch.float32, device=device)
        nmask = torch.zeros((rows, d), dtype=torch.bool, device=device)
        if size and m_w:
            row_ptr = to_device(resident.row_ptr, device).long()
            deg = row_ptr[1:] - row_ptr[:-1]
            ridx = torch.repeat_interleave(
                torch.arange(size, device=device), deg, output_size=m_w)
            cidx = torch.arange(m_w, device=device) - row_ptr[ridx]
            nbr[ridx, cidx] = to_device(resident.dst, device)
            nw[ridx, cidx] = to_device(resident.wgt, device)
            nmask[ridx, cidx] = True
        return (nbr, nw, nmask), self.partition_prepare_nbytes(shapes)

    def partition_move(self, sweeps, inputs, labels_loc, cand_owned,
                       seed: int, bound: int) -> torch.Tensor:
        nbr, nw, nmask = inputs
        rows = nbr.shape[0]
        cand = pad_to_device(cand_owned, rows, sweeps.device)
        best_lab, best_w, cur_w = ops.label_argmax(nbr, nw, nmask, labels_loc,
                                                   seed)
        adopt = cand & (best_w > cur_w.clamp_min(0.0))
        return torch.where(adopt, best_lab, labels_loc[:rows])

    def partition_wake(self, sweeps, inputs, changed_loc) -> torch.Tensor:
        nbr, _nw, nmask = inputs
        return (changed_loc[nbr] & nmask).any(dim=1)

    def partition_split(self, sweeps, inputs, comm_loc, labels_loc,
                        active_owned, bound: int) -> torch.Tensor:
        nbr, _nw, nmask = inputs
        rows = nbr.shape[0]
        new = ops.min_label(nbr, nmask, labels_loc, comm_loc)
        if sweeps.prune:
            active = pad_to_device(active_owned, rows, sweeps.device)
            new = torch.where(active, new, labels_loc[:rows])
        return new

    def partition_split_wake(self, sweeps, inputs, comm_loc,
                             changed_loc) -> torch.Tensor:
        nbr, _nw, nmask = inputs
        rows = nbr.shape[0]
        same = (comm_loc[nbr] == comm_loc[:rows, None]) & nmask
        return (changed_loc[nbr] & same).any(dim=1)

    # Fused partition sweeps: the out-of-core lazy-wake loop matches the
    # fused kernels' contract, so wake + move (and split-wake + min-label)
    # are one launch per visit.  Padded tile rows have no real cell and a
    # false klass, so they never wake or adopt.

    def partition_move_fused(self, sweeps, inputs, labels_loc, changed_loc,
                             active_owned, cand_prev_owned, klass_owned,
                             seed: int, bound: int):
        nbr, nw, nmask = inputs
        rows, dev = nbr.shape[0], sweeps.device
        real = torch.ones(rows, dtype=torch.bool, device=dev)
        return ops.fused_move(nbr, nw, nmask, labels_loc, changed_loc,
                              pad_to_device(active_owned, rows, dev),
                              pad_to_device(cand_prev_owned, rows, dev),
                              pad_to_device(klass_owned, rows, dev), real,
                              seed)

    def partition_split_fused(self, sweeps, inputs, comm_loc, labels_loc,
                              changed_loc, bound: int) -> torch.Tensor:
        nbr, _nw, nmask = inputs
        return ops.fused_split(nbr, nmask, labels_loc, comm_loc, changed_loc,
                               sweeps.prune)
