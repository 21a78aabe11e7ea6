"""Segment backend: the edge-list sort + segment-reduce path.

Wraps ``core.lpa.lpa_run`` (propagation) and ``core.split.split_lp``
(Split-Last) behind the backend protocol, and their batched twins in
``core.batch`` behind the batched trio, in plain tensor operations on any
device.  It is ``auto``'s choice for skewed graphs and the tile
backend's oracle.

With ``bucketing="exact"`` the convergence threshold is the Python-float
``int(tau * n)``; with ``"pow2"`` it is taken in float32 from the real
vertex count, as the JAX engine does.

Profiling (``EngineConfig.profile``) passes ``profile`` / ``profile_rows``
down to the core loops, which fill their buffers on the device; ``run``
and ``run_batch`` fetch them once with the labels.

The partition hooks run one out-of-core partition visit each
(:mod:`repro_torch.partition.ooc`) over a compact local Graph.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.batch import (
    lpa_run_batched,
    split_lp_batched,
    warm_state_rows,
)
from repro_torch.core.graph import Graph
from repro_torch.core.lpa import lpa_move, lpa_run, neighbors_of
from repro_torch.core.split import min_label_sweep, min_label_wake, split_lp
from repro_torch.engine.bucketing import (
    BatchBucketKey,
    BucketKey,
    pad_active,
    pad_graph,
    pad_labels,
)
from repro_torch.engine.cache import PLAN_LOG
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import (
    BackendRun,
    BatchBackendRun,
    batch_index,
    device_sync,
    pad_to_device,
    profile_plan,
    register_backend,
    to_device,
    to_host,
)
from repro_torch.obs.convergence import batch_profiles, solo_profile


@register_backend("segment")
class SegmentBackend:
    name = "segment"
    supports_batch = True
    supports_partition = True

    def plan_key(self, config: EngineConfig) -> tuple:
        return ()

    def build(self, bucket: BucketKey, config: EngineConfig,
              device: torch.device):
        do_split = config.split in ("lp", "lpp")
        PLAN_LOG.record("segment:propagate")
        if do_split:
            PLAN_LOG.record("segment:split")
        return SimpleNamespace(
            device=device, exact=config.bucketing == "exact",
            tau=config.tau, max_iterations=config.max_iterations,
            do_split=do_split, prune=config.split == "lpp",
            shortcut=config.shortcut, **profile_plan(config, do_split))

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig) -> Graph:
        return pad_graph(graph, bucket)

    def run(self, plan, inputs: Graph, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun:
        g = inputs
        dev = plan.device
        labels0 = to_device(
            np.arange(g.n, dtype=np.int32) if init_labels is None
            else pad_labels(init_labels, n_real, g.n), dev)
        active0 = to_device(pad_active(init_active, n_real, g.n), dev)

        device_sync(dev)
        t0 = time.perf_counter()
        out = lpa_run(g, tau=plan.tau, max_iterations=plan.max_iterations,
                      init_labels=labels0,
                      n_real=None if plan.exact else n_real,
                      init_active=active0, profile=plan.profile)
        state, pbuf = out if plan.profile else (out, None)
        labels = state.labels
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters, sbuf = 0, None
        if plan.do_split:
            out = split_lp(g, labels, prune=plan.prune,
                           shortcut=plan.shortcut,
                           profile_rows=plan.split_rows, n_real=n_real)
            st, sbuf = out if plan.split_rows else (out, None)
            labels, split_iters = st.labels, st.iterations
        device_sync(dev)
        t2 = time.perf_counter()
        labels, pbuf, sbuf = to_host(labels, n_real, pbuf, sbuf)
        profile = solo_profile(pbuf, state.iteration, sbuf, split_iters,
                               plan.split_rows, n_real) \
            if plan.profile else None
        return BackendRun(labels=labels, lpa_iterations=state.iteration,
                          split_iterations=split_iters,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1,
                          profile=profile)

    # --- batched dispatch (GraphBatch disjoint-union packing) ---

    def build_batch(self, bucket: BatchBucketKey, config: EngineConfig,
                    device: torch.device):
        do_split = config.split in ("lp", "lpp")
        PLAN_LOG.record("segment:batch_propagate")
        if do_split:
            PLAN_LOG.record("segment:batch_split")
        return SimpleNamespace(
            device=device, tau=config.tau,
            max_iterations=config.max_iterations, do_split=do_split,
            prune=config.split == "lpp", shortcut=config.shortcut,
            **profile_plan(config, do_split))

    def prepare_batch(self, batch, bucket: BatchBucketKey,
                      config: EngineConfig):
        g = pad_graph(batch.graph, BucketKey(bucket.n, bucket.m, bucket.d))
        return g, batch_index(batch, bucket.k, bucket.n, g.device)

    def run_batch(self, plan, inputs,
                  init_labels: np.ndarray | None = None,
                  init_active: np.ndarray | None = None) -> BatchBackendRun:
        g, b = inputs
        dev = plan.device
        lab0, act0 = warm_state_rows(g.n, b.voffset_host, init_labels,
                                     init_active)
        labels0, active0 = to_device(lab0, dev), to_device(act0, dev)

        device_sync(dev)
        t0 = time.perf_counter()
        out = lpa_run_batched(
            g, b.sizes, b.graph_id, b.voffset, labels0, active0,
            tau=plan.tau, max_iterations=plan.max_iterations,
            profile=plan.profile)
        labels, iters, pbuf = out if plan.profile else (*out, None)
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters, sbuf = np.zeros(len(b.sizes), np.int32), None
        if plan.do_split:
            out = split_lp_batched(
                g, b.sizes, b.graph_id, b.voffset, labels, prune=plan.prune,
                shortcut=plan.shortcut, profile_rows=plan.split_rows)
            labels, split_iters, sbuf = out if plan.split_rows \
                else (*out, None)
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
    # One partition's edge window runs as a compact local Graph: rows
    # [0, size) are the owned vertex range, rows [size, n_local) the halo
    # imports (no out-edges, so they never adopt).  Label *values* stay
    # global vertex ids (the tie-break hash is a function of the raw
    # value), so every sweep takes the whole graph's vertex count as its
    # ``label_bound`` sentinel.  Local row counts and edge windows are
    # padded to one per-run shape.  Each hook takes device tensors for the
    # local vectors and host arrays for the owned-row state, and returns
    # device tensors.

    def build_partition(self, config: EngineConfig, device: torch.device):
        # The fused sweeps are plain tensor compositions here (one pass
        # over the window's edges instead of two per visit), so 'auto'
        # fuses on every device, as the JAX engine's segment path does.
        PLAN_LOG.record("segment:partition")
        return SimpleNamespace(device=device, prune=config.split == "lpp",
                               fuse=config.fuse_sweeps != "off")

    def partition_caps(self, budget: int, d_bucket: int):
        """(max_edges, max_vertices) per partition for a byte budget.

        One resident partition costs ~12 B/edge of locally remapped window
        plus ~13 B/edge x pow2 padding of device CSR and ~24 B/row of
        vertex-indexed locals; halving the budget leaves the LRU headroom
        for the staged window and the label caches.
        """
        half = max(budget // 2, 1)
        return max(half // 64, 1), max(half // 48, 8)

    def partition_prepare_nbytes(self, shapes) -> int:
        return shapes.m * 13 + (shapes.n_loc + 1) * 4 + shapes.n_loc * 4

    def prepare_partition(self, resident, shapes, config: EngineConfig,
                          device: torch.device):
        """Pad a resident slice to the run's local-Graph shape, on
        ``device``."""
        n_loc, m = shapes.n_loc, shapes.m
        m_w = len(resident.src)
        src = np.zeros(m, np.int32)
        dst = np.zeros(m, np.int32)
        wgt = np.zeros(m, np.float32)
        mask = np.zeros(m, bool)
        src[:m_w] = resident.src
        dst[:m_w] = resident.dst
        wgt[:m_w] = resident.wgt
        mask[:m_w] = True
        row_ptr = np.full(n_loc + 1, m_w, np.int32)
        row_ptr[: resident.size + 1] = resident.row_ptr
        g = Graph(n=n_loc, m_pad=m, num_edges=m_w,
                  row_ptr=to_device(row_ptr, device),
                  src=to_device(src, device), dst=to_device(dst, device),
                  wgt=to_device(wgt, device),
                  edge_mask=to_device(mask, device),
                  kdeg=torch.zeros(n_loc, dtype=torch.float32,
                                   device=device))
        return g, self.partition_prepare_nbytes(shapes)

    def partition_move(self, sweeps, inputs: Graph, labels_loc, cand_owned,
                       seed: int, bound: int) -> torch.Tensor:
        cand = pad_to_device(cand_owned, inputs.n, sweeps.device)
        new, _, _ = lpa_move(inputs, labels_loc, cand, seed,
                             label_bound=bound)
        return new

    def partition_wake(self, sweeps, inputs: Graph,
                       changed_loc) -> torch.Tensor:
        return neighbors_of(inputs, changed_loc)

    def partition_split(self, sweeps, inputs: Graph, comm_loc, labels_loc,
                        active_owned, bound: int) -> torch.Tensor:
        active = pad_to_device(active_owned, inputs.n, sweeps.device)
        return min_label_sweep(inputs, comm_loc, labels_loc, active, bound,
                               prune=sweeps.prune)

    def partition_split_wake(self, sweeps, inputs: Graph, comm_loc,
                             changed_loc) -> torch.Tensor:
        return min_label_wake(inputs, comm_loc, changed_loc)

    # Fused partition sweeps: the out-of-core lazy-wake loop lets wake +
    # active refresh + move (and split-wake + min-label) run as one call
    # per visit, with no host round trip of the intermediate wake mask.

    def partition_move_fused(self, sweeps, inputs: Graph, labels_loc,
                             changed_loc, active_owned, cand_prev_owned,
                             klass_owned, seed: int, bound: int):
        dev = sweeps.device
        wake = neighbors_of(inputs, changed_loc)
        act = ((pad_to_device(active_owned, inputs.n, dev)
                & ~pad_to_device(cand_prev_owned, inputs.n, dev)) | wake)
        new, _, _ = lpa_move(inputs, labels_loc,
                             act & pad_to_device(klass_owned, inputs.n, dev),
                             seed, label_bound=bound)
        return new, act

    def partition_split_fused(self, sweeps, inputs: Graph, comm_loc,
                              labels_loc, changed_loc,
                              bound: int) -> torch.Tensor:
        if sweeps.prune:
            sact = min_label_wake(inputs, comm_loc, changed_loc)
        else:
            # no-prune sweeps every row; a row with no same-community
            # neighbor reduces to its own label, so all-ones is exact
            sact = torch.ones(inputs.n, dtype=torch.bool,
                              device=sweeps.device)
        return min_label_sweep(inputs, comm_loc, labels_loc, sact, bound,
                               prune=sweeps.prune)
