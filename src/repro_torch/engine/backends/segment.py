"""Segment backend: the edge-list sort + segment-reduce path.

Wraps ``core.lpa.lpa_run`` (propagation) and ``core.split.split_lp``
(Split-Last) behind the backend protocol, and their batched twins in
``core.batch`` behind the batched trio, in plain tensor operations on any
device.  It is ``auto``'s choice for skewed graphs and the tile
backend's oracle.

With ``bucketing="exact"`` the convergence threshold is the Python-float
``int(tau * n)``; with ``"pow2"`` it is taken in float32 from the real
vertex count, as the JAX engine does.
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
from repro_torch.core.lpa import lpa_run
from repro_torch.core.split import split_lp
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
    register_backend,
    to_device,
    to_host,
)


@register_backend("segment")
class SegmentBackend:
    name = "segment"
    supports_batch = True

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
            shortcut=config.shortcut)

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
        state = lpa_run(g, tau=plan.tau, max_iterations=plan.max_iterations,
                        init_labels=labels0,
                        n_real=None if plan.exact else n_real,
                        init_active=active0)
        labels = state.labels
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters = 0
        if plan.do_split:
            st = split_lp(g, labels, prune=plan.prune, shortcut=plan.shortcut)
            labels, split_iters = st.labels, st.iterations
        device_sync(dev)
        t2 = time.perf_counter()
        return BackendRun(labels=to_host(labels, n_real),
                          lpa_iterations=state.iteration,
                          split_iterations=split_iters,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1)

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
            prune=config.split == "lpp", shortcut=config.shortcut)

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
        labels, iters = lpa_run_batched(
            g, b.sizes, b.graph_id, b.voffset, labels0, active0,
            tau=plan.tau, max_iterations=plan.max_iterations)
        device_sync(dev)
        t1 = time.perf_counter()
        split_iters = np.zeros(len(b.sizes), np.int32)
        if plan.do_split:
            labels, split_iters = split_lp_batched(
                g, b.sizes, b.graph_id, b.voffset, labels, prune=plan.prune,
                shortcut=plan.shortcut)
        device_sync(dev)
        t2 = time.perf_counter()
        return BatchBackendRun(labels=to_host(labels, b.n_total),
                               lpa_iterations=iters,
                               split_iterations=split_iters,
                               lpa_seconds=t1 - t0, split_seconds=t2 - t1)
