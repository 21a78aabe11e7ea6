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
