"""The Engine: one entry point for a GSL-LPA fit, in PyTorch.

    from repro_torch.engine import Engine, EngineConfig

    eng = Engine(EngineConfig())            # runs on CUDA
    result = eng.fit(graph)                 # DetectionResult
    result = eng.fit(graph2)                # same bucket -> plan reused
    result = eng.fit(graph, init_labels=result.labels)   # warm start

``fit`` buckets the graph, fetches (or builds) the backend's plan from the
plan cache, runs the backend on the configured device, applies the host
split when requested, compacts the labels on the host, and optionally
attaches quality metrics.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

import repro_torch.engine.backends  # noqa: F401  (registers the backends)
from repro_torch.core.graph import Graph
from repro_torch.core.split import split_bfs_host
from repro_torch.engine.bucketing import bucket_for
from repro_torch.engine.cache import GLOBAL_CACHE, PLAN_LOG, PlanCache
from repro_torch.engine.config import DetectionResult, EngineConfig, unported
from repro_torch.engine.registry import (
    choose_backend,
    device_sync,
    get_backend,
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means CUDA; a CUDA device that is missing is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the engine runs on CUDA by default, but no CUDA device is "
            "available; pass EngineConfig(device='cpu') to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _compact_host(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense [0, K) relabeling in rank order of the label values."""
    uniq, inv = np.unique(np.asarray(labels), return_inverse=True)
    return inv.astype(np.int32).reshape(-1), len(uniq)


def _check_init_labels(labels, n: int, name: str) -> np.ndarray:
    """Validate warm-start labels: (n,) vertex-id-valued — reject stale
    labels from a graph of another size loudly, never truncate."""
    labels = np.asarray(labels)
    if labels.shape != (n,):
        raise ValueError(
            f"{name} has shape {labels.shape} for a graph with {n} "
            f"vertices — stale warm-start labels from a different graph? "
            f"Re-detect cold or extend the labels to the new vertex set.")
    labels = labels.astype(np.int32)
    if n and (labels.min() < 0 or labels.max() >= n):
        raise ValueError(f"{name} must be vertex-id-valued in [0, {n})")
    return labels


def _check_init_active(active, n: int, name: str) -> np.ndarray:
    active = np.asarray(active).astype(bool)
    if active.shape != (n,):
        raise ValueError(f"{name} has shape {active.shape} for a graph "
                         f"with {n} vertices")
    return active


class Engine:
    """GSL-LPA engine with pluggable backends and a plan cache.

    ``cache=None`` shares the process-wide :data:`GLOBAL_CACHE`.
    """

    def __init__(self, config: EngineConfig | None = None,
                 cache: PlanCache | None = None):
        self.config = config if config is not None else EngineConfig()
        self.device = resolve_device(self.config.device)
        self.cache = cache if cache is not None else GLOBAL_CACHE

    def fit(self, graph: Graph, init_labels=None, init_active=None, *,
            backend: str | None = None,
            memory_budget: int | str | None = None) -> DetectionResult:
        """Detect communities; returns a :class:`DetectionResult`.

        ``init_labels``: optional (n,) vertex-id-valued initial assignment
        (warm start).  ``init_active``: optional (n,) unprocessed-seed
        mask, honored only alongside warm labels (a frontier means nothing
        relative to a cold singleton start).  ``backend`` overrides the
        configured strategy for this call.  The graph is moved to the
        engine's device if it lives elsewhere.
        """
        if memory_budget is not None:
            raise unported("memory_budget")
        if isinstance(graph, (str, os.PathLike)):
            raise unported("graph file paths")
        if not isinstance(graph, Graph):
            raise TypeError(f"fit expects a Graph, got "
                            f"{type(graph).__name__}")
        n = graph.n
        if init_active is not None:   # validate even when about to drop it
            init_active = _check_init_active(init_active, n, "init_active")
        if init_labels is not None:
            init_labels = _check_init_labels(init_labels, n, "init_labels")
        else:
            init_active = None
        return self._fit_resolved(graph.to(self.device), init_labels,
                                  init_active, backend,
                                  init_labels is not None)

    def fit_many(self, graphs, **kwargs):
        raise unported("fit_many")

    def _fit_resolved(self, graph: Graph, init_labels, init_active,
                      backend: str | None, warm_started: bool,
                      ) -> DetectionResult:
        cfg = self.config
        name = backend or cfg.backend
        if name == "auto":
            name = choose_backend(graph, cfg, self.device)
        be = get_backend(name)

        bucket = bucket_for(graph, bucketing=cfg.bucketing,
                            min_vertex_bucket=cfg.min_vertex_bucket,
                            min_edge_bucket=cfg.min_edge_bucket)
        key = (name, bucket, cfg.bucketing, cfg.algo_key(),
               be.plan_key(cfg), str(self.device))
        plan, cache_hit = self.cache.get_or_build(
            key, lambda: be.build(bucket, cfg, self.device))

        t0 = time.perf_counter()
        inputs = be.prepare(graph, bucket, cfg)
        device_sync(self.device)
        t_prep = time.perf_counter() - t0

        run = be.run(plan, inputs, graph.n, init_labels, init_active)
        labels = np.asarray(run.labels)[: graph.n]

        split_seconds = run.split_seconds
        if cfg.split == "bfs_host":
            t0 = time.perf_counter()
            labels = split_bfs_host(graph, labels)
            split_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        labels, k = _compact_host(labels)
        t_compact = time.perf_counter() - t0

        result = DetectionResult(
            labels=labels, num_communities=k, backend=name,
            lpa_iterations=run.lpa_iterations,
            split_iterations=run.split_iterations,
            timings={"prepare": t_prep, "propagation": run.lpa_seconds,
                     "split": split_seconds, "compact": t_compact},
            bucket=tuple(bucket), cache_hit=cache_hit,
            warm_started=warm_started, device=str(self.device))
        if cfg.compute_metrics:
            self._attach_metrics(result, graph)
        return result

    def _attach_metrics(self, result: DetectionResult, graph: Graph) -> None:
        from repro_torch.core.modularity import modularity
        labels = torch.from_numpy(result.labels).to(graph.device)
        result.modularity = float(modularity(graph, labels))
        result.check_connected(graph)

    def stats(self) -> dict:
        """Plan-cache observability: plans, hits, misses, builds per stage."""
        return {**self.cache.stats(), "plan_builds": PLAN_LOG.snapshot()}
