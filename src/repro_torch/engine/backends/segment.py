"""Segment backend: the edge-list sort + segment-reduce path.

Wraps ``core.lpa.lpa_run`` (propagation) and ``core.split.split_lp``
(Split-Last) behind the backend protocol, in plain tensor operations on
any device.  It is ``auto``'s choice for skewed graphs and the tile
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

from repro_torch.core.graph import Graph
from repro_torch.core.lpa import lpa_run
from repro_torch.core.split import split_lp
from repro_torch.engine.bucketing import (
    BucketKey,
    pad_active,
    pad_graph,
    pad_labels,
)
from repro_torch.engine.cache import PLAN_LOG
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import (
    BackendRun,
    device_sync,
    register_backend,
)


@register_backend("segment")
class SegmentBackend:
    name = "segment"

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
        labels0 = torch.from_numpy(pad_labels(
            np.arange(n_real, dtype=np.int32) if init_labels is None
            else init_labels, n_real, g.n)).to(dev)
        active0 = torch.from_numpy(pad_active(init_active, n_real,
                                              g.n)).to(dev)

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
        return BackendRun(labels=labels.cpu().numpy(),
                          lpa_iterations=state.iteration,
                          split_iterations=split_iters,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1)
