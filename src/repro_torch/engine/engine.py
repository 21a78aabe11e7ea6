"""The Engine: one entry point for a GSL-LPA fit, in PyTorch.

    from repro_torch.engine import Engine, EngineConfig

    eng = Engine(EngineConfig())            # runs on CUDA
    result = eng.fit(graph)                 # DetectionResult
    result = eng.fit(graph2)                # same bucket -> plan reused
    result = eng.fit(graph, init_labels=result.labels)   # warm start
    result = eng.fit("road.mtx")            # a graph file, via repro_torch.io
    result = eng.fit("road.mtx", memory_budget="256MB")  # out of core
    results = eng.fit_many([g1, g2, g3])    # one batched dispatch

``fit`` buckets the graph, fetches (or builds) the backend's plan from the
plan cache, runs the backend on the configured device, applies the host
split when requested, compacts the labels on the host, and optionally
attaches quality metrics, a convergence profile (``profile``) and a
quality report (``quality``).  ``fit_many`` packs k graphs into one disjoint
union and runs the backend's batched plan once; each member's result
equals its solo ``fit``.  Under a ``memory_budget`` smaller than the
graph's edge arrays, ``fit`` runs out of core (``repro_torch.partition``):
partition by partition on the same device, with the in-core labels.

Warm starts: ``init_labels`` seeds propagation with an assignment and
``init_active`` seeds the unprocessed flags (pass a delta's affected
frontier).  With ``warm_start="auto"`` the engine keeps a bounded LRU of
``graph_fingerprint -> last labels``, stored after every fit and every
``fit_many`` member, so a re-fit of a structurally identical graph starts
warm; ``fit_many`` resolves its members against the cache as it stood
before the dispatch, so members never warm-start off each other.

Observability (``repro_torch.obs``): each engine claims an ``engine``
registry scope (``fits``, ``batch_fits``, the warm cache's
``warm_hits`` / ``warm_misses`` / ``warm_evictions`` / ``warm_entries``,
and ``quality.*`` under ``quality != "off"``) and wraps its stages in the
spans ``engine.fit`` / ``engine.fit_many`` / ``engine.fit_ooc``,
``engine.prepare``,
``engine.dispatch``, ``engine.split_host``, ``engine.compact`` and
``engine.quality``.  The timed stages end with a device synchronize, so a
span's length includes its device work.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

import repro_torch.engine.backends  # noqa: F401  (registers the backends)
from repro_torch.core.batch import GraphBatch
from repro_torch.core.graph import Graph, graph_fingerprint
from repro_torch.core.split import split_bfs_host
from repro_torch.engine.bucketing import batch_bucket_for, bucket_for
from repro_torch.engine.cache import (
    GLOBAL_CACHE,
    PLAN_LOG,
    PlanCache,
    plan_context,
)
from repro_torch.engine.config import DetectionResult, EngineConfig
from repro_torch.engine.registry import (
    choose_backend,
    choose_backend_batch,
    device_sync,
    get_backend,
)
from repro_torch.obs import REGISTRY, span


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


def _as_graph(graph) -> Graph:
    """A Graph, or a path to a graph file (``.mtx`` / SNAP edge list)
    loaded through :func:`repro_torch.io.load_graph`: the first load of a
    file parses it and stores its CSR, later loads map the store entry."""
    if isinstance(graph, Graph):
        return graph
    if isinstance(graph, str) or hasattr(graph, "__fspath__"):
        from repro_torch.io import load_graph
        return load_graph(graph)
    raise TypeError(f"fit expects a Graph or a graph-file path, got "
                    f"{type(graph).__name__}")


def _compact_host(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense [0, K) relabeling in rank order of the label values: the
    inverse and count of ``np.unique``, in O(n + max label).

    Labels here are vertex ids (split roots, local batch ids or checked
    warm-start labels), so a presence mask over ``[0, max + 1)`` and its
    running count give each value's rank.
    """
    labels = np.asarray(labels).reshape(-1)
    if labels.size == 0:
        return np.zeros(0, np.int32), 0
    if labels.min() < 0:
        raise ValueError("labels to compact must be non-negative vertex ids")
    present = np.zeros(int(labels.max()) + 1, dtype=bool)
    present[labels] = True
    rank = np.cumsum(present, dtype=np.int32)
    return rank[labels] - 1, int(rank[-1])


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


class _WarmCache:
    """Bounded LRU of ``graph_fingerprint -> last compacted labels``, the
    state of ``warm_start="auto"``.  One engine serves the micro-batcher's
    worker, client threads calling ``fit`` and ``stats()`` pollers at once,
    so every access holds the lock.  Lookups and LRU drops count in the
    registry ``scope`` (``warm_hits``, ``warm_misses``,
    ``warm_evictions``; ``warm_entries`` is a gauge), which ``stats()``
    reads back."""

    def __init__(self, max_entries: int, scope):
        self.max_entries = int(max_entries)
        self._entries: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = scope.counter("warm_hits")
        self._misses = scope.counter("warm_misses")
        self._evictions = scope.counter("warm_evictions")
        self._count = scope.gauge("warm_entries")

    def get(self, fp: tuple) -> np.ndarray | None:
        with self._lock:
            labels = self._entries.get(fp)
            if labels is None:
                self._misses.inc()
            else:
                self._hits.inc()
                self._entries.move_to_end(fp)
            return labels

    def put(self, fp: tuple, labels: np.ndarray) -> None:
        with self._lock:
            self._entries[fp] = labels
            self._entries.move_to_end(fp)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self._evictions.inc()
            self._count.set(len(self._entries))

    def stats(self) -> dict:
        with self._lock:
            return {"warm_entries": len(self._entries),
                    "warm_capacity": self.max_entries,
                    "warm_hits": self._hits.value,
                    "warm_misses": self._misses.value,
                    "warm_evictions": self._evictions.value}


class Engine:
    """GSL-LPA engine with pluggable backends and a plan cache.

    ``cache=None`` shares the process-wide :data:`GLOBAL_CACHE`; the
    warm-start cache is per engine.
    """

    def __init__(self, config: EngineConfig | None = None,
                 cache: PlanCache | None = None):
        self.config = config if config is not None else EngineConfig()
        self.device = resolve_device(self.config.device)
        self.cache = cache if cache is not None else GLOBAL_CACHE
        self._obs = REGISTRY.scope("engine")
        self._warm = _WarmCache(self.config.warm_cache_size, self._obs)
        self._m_fits = self._obs.counter("fits")
        self._m_batch_fits = self._obs.counter("batch_fits")
        # claimed here, so concurrent fits never race a lazy scope() call
        self._q_obs = self._obs.scope("quality") \
            if self.config.quality != "off" else None

    # --- warm-start resolution ---

    def _auto_fp(self, graph: Graph) -> tuple | None:
        return graph_fingerprint(graph) \
            if self.config.warm_start == "auto" else None

    def _resolve_warm(self, n: int, init_labels, init_active,
                      fp: tuple | None, name: str):
        """Checked (init_labels, init_active, warm_started) of one fit.

        Explicit labels win; else, under ``warm_start="auto"``, the warm
        cache is consulted.  A frontier means nothing relative to a cold
        singleton start, so when no labels resolve (none given and a cache
        miss) ``init_active`` is dropped, after being checked all the same,
        and the fit is a full cold detection.
        """
        if init_labels is None and fp is not None:
            init_labels = self._warm.get(fp)
        if init_active is not None:
            init_active = _check_init_active(
                init_active, n, name.replace("labels", "active"))
        if init_labels is None:
            return None, None, False
        return _check_init_labels(init_labels, n, name), init_active, True

    def fit(self, graph, init_labels=None, init_active=None, *,
            backend: str | None = None,
            memory_budget: int | str | None = None) -> DetectionResult:
        """Detect communities; returns a :class:`DetectionResult`.

        ``graph``: a :class:`Graph` or a path to a graph file, loaded
        through :func:`repro_torch.io.load_graph` (parsed once per file
        content, then mapped from the CSR store).
        ``init_labels``: optional (n,) vertex-id-valued initial assignment
        (warm start).  ``init_active``: optional (n,) unprocessed-seed
        mask, honored only alongside warm labels (a frontier means nothing
        relative to a cold singleton start).  ``backend`` overrides the
        configured strategy for this call.  The graph is moved to the
        engine's device if it lives elsewhere.

        ``memory_budget`` (bytes, or ``"64MB"``-style; defaults to
        ``config.memory_budget``) routes the fit: in core when the graph's
        edge arrays fit the budget, otherwise out of core, partitioned
        CSR slices swept one resident partition at a time with halo-label
        exchange (:mod:`repro_torch.partition`), with labels equal to the
        in-core fit's.  For a path the routing reads only the store
        entry's metadata, so a file bigger than the budget is never
        materialized.
        """
        budget = memory_budget if memory_budget is not None \
            else self.config.memory_budget
        if budget is not None:
            from repro_torch.partition.ooc import (
                IN_CORE_EDGE_BYTES,
                in_core_edge_bytes,
                open_source,
            )
            from repro_torch.partition.plan import parse_bytes
            budget = parse_bytes(budget)
            if isinstance(graph, Graph):
                # routing from metadata; no source unless it is needed
                too_big = graph.m_pad * IN_CORE_EDGE_BYTES > budget
                source = open_source(graph) if too_big else None
            else:
                source = open_source(graph)  # the store entry's handle
                too_big = in_core_edge_bytes(source) > budget
            if too_big:
                return self._fit_ooc(source, budget, init_labels,
                                     init_active, backend)
            if source is not None:
                # fits in core: the full graph from the handle already
                # open (no second content hash or store open)
                graph = source.to_graph()
        graph = _as_graph(graph)
        fp = self._auto_fp(graph)
        init_labels, init_active, warm = self._resolve_warm(
            graph.n, init_labels, init_active, fp, "init_labels")
        result = self._fit_resolved(graph, init_labels, init_active,
                                    backend, warm)
        if fp is not None:
            self._warm.put(fp, result.labels)
        return result

    def _fit_ooc(self, source, budget: int, init_labels, init_active,
                 backend: str | None) -> DetectionResult:
        """Out-of-core partitioned fit over an array source, on the
        engine's device."""
        from repro_torch.partition.ooc import fit_out_of_core
        cfg = self.config
        if cfg.compute_metrics:
            raise ValueError(
                "compute_metrics needs the full graph on the device; "
                "compute quality metrics separately after an out-of-core "
                "fit")
        fp = source.fingerprint() if cfg.warm_start == "auto" else None
        fp = tuple(fp) if fp else None
        init_labels, init_active, warm_started = self._resolve_warm(
            source.n, init_labels, init_active, fp, "init_labels")

        with span("engine.fit_ooc", n=source.n):
            run = fit_out_of_core(source, cfg, memory_budget=budget,
                                  backend=backend, cache=self.cache,
                                  init_labels=init_labels,
                                  init_active=init_active,
                                  device=self.device)
            t0 = time.perf_counter()
            with span("engine.compact"):
                labels, k = _compact_host(run.labels)
            t_compact = time.perf_counter() - t0

        self._m_fits.inc()
        result = DetectionResult(
            labels=labels, num_communities=k, backend=run.backend,
            lpa_iterations=run.lpa_iterations,
            split_iterations=run.split_iterations,
            timings={"prepare": run.plan_seconds,
                     "propagation": run.lpa_seconds,
                     "split": run.split_seconds, "compact": t_compact},
            bucket=(source.n, source.num_edges), cache_hit=run.cache_hit,
            warm_started=warm_started, device=str(self.device),
            partitions=run.num_partitions, ooc=run.stats(),
            profile=run.profile)
        if cfg.quality != "off":
            # host-only report: out of core the whole graph never sits on
            # the device, so modularity and the disconnected fraction stay
            # None; sizes, count and churn still come
            self._attach_quality(result, None, init_labels)
        if fp is not None:
            self._warm.put(fp, result.labels)
        return result

    def fit_many(self, graphs, *, init_labels=None, init_active=None,
                 backend: str | None = None) -> list[DetectionResult]:
        """Detect communities for k graphs in one batched dispatch.

        The graphs are packed into a disjoint-union super-graph
        (:class:`repro_torch.core.batch.GraphBatch`) and run by the
        backend's batched plan, cached per *batch bucket* (graph count,
        total vertices, total edges, max degree).  Each member's labels
        and iteration counts equal ``fit`` on that graph alone, cold or
        warm.

        ``graphs``: Graphs or graph-file paths, as ``fit`` takes them.
        ``init_labels`` / ``init_active``: optional length-k sequences of
        per-member warm-start labels and unprocessed-seed masks (None
        entries for cold members), each taken as ``fit`` takes it.  Under
        ``warm_start="auto"`` members without labels look up the warm
        cache as it stood before the dispatch, and every member's result
        is stored afterwards.

        Batch-level stage times (prepare, propagation, split) are given to
        each member pro rata by its share of the packed work (vertices +
        edges) under ``"prorated_*"`` keys; the host split and the
        compaction are timed per member.  A backend without a batched
        path (``sharded``) runs the members as sequential fits, with the
        same warm-start semantics.
        """
        graphs = [_as_graph(g) for g in graphs]
        if not graphs:
            return []
        k = len(graphs)
        fps = [self._auto_fp(g) for g in graphs]
        # every lookup before the dispatch and every store after it: the
        # members never warm-start off each other
        resolved = [self._resolve_warm(g.n, lab, act, fp,
                                       f"init_labels[{i}]")
                    for i, (g, lab, act, fp) in enumerate(zip(
                        graphs, self._per_member(init_labels, k,
                                                 "init_labels"),
                        self._per_member(init_active, k, "init_active"),
                        fps))]
        labels_r, active_r, warm_r = (list(x) for x in zip(*resolved))

        name = backend or self.config.backend
        if name == "auto":
            name = choose_backend_batch(graphs, self.config, self.device)
        be = get_backend(name)
        if getattr(be, "supports_batch", False):
            results = self._fit_many_packed(graphs, labels_r, active_r,
                                            warm_r, name, be)
        else:
            # sequential fits (the sharded backend), warm state resolved
            # against the cache as it stood before the first
            results = [self._fit_resolved(g, labels_r[i], active_r[i],
                                          name, warm_r[i])
                       for i, g in enumerate(graphs)]
        for fp, res in zip(fps, results):
            if fp is not None:
                self._warm.put(fp, res.labels)
        return results

    @staticmethod
    def _per_member(seq, k: int, name: str) -> list:
        if seq is None:
            return [None] * k
        seq = list(seq)
        if len(seq) != k:
            raise ValueError(f"{name} has {len(seq)} entries for a batch "
                             f"of {k} graphs")
        return seq

    def _fit_many_packed(self, graphs, labels_r, active_r, warm_r,
                         name: str, be) -> list[DetectionResult]:
        cfg = self.config
        with span("engine.fit_many", backend=name, k=len(graphs)):
            t0 = time.perf_counter()
            with span("engine.prepare"):
                batch = GraphBatch.pack(graphs, device=self.device)
                bucket = batch_bucket_for(
                    batch, bucketing=cfg.bucketing,
                    min_vertex_bucket=cfg.min_vertex_bucket,
                    min_edge_bucket=cfg.min_edge_bucket)
                key = (name, "batch", bucket, cfg.bucketing, cfg.algo_key(),
                       be.plan_key(cfg), self.device)
                with plan_context(name, ("batch", *bucket)):
                    plan, cache_hit = self.cache.get_or_build(
                        key, lambda: be.build_batch(bucket, cfg, self.device))
                inputs = be.prepare_batch(batch, bucket, cfg)
                # a solo graph's vertex ids are its local ids, so
                # per-member warm labels pack as they are
                labels0 = batch.pack_labels(labels_r)
                active0 = batch.pack_active(active_r)
                device_sync(self.device)
            t_prep = time.perf_counter() - t0

            with span("engine.dispatch"):
                run = be.run_batch(plan, inputs, labels0, active0)

            # One dispatch serves every member, so per-member stage
            # seconds are not measurable: each member carries its share of
            # the packed work (vertices + edges) of the batch's times.
            work = (batch.sizes + batch.edge_counts).astype(np.float64)
            weights = work / work.sum() if work.sum() > 0 \
                else np.full(len(graphs), 1.0 / len(graphs))
            results = []
            for i, graph in enumerate(graphs):
                lo, hi = int(batch.offsets[i]), int(batch.offsets[i + 1])
                labels = run.labels[lo:hi]
                w = float(weights[i])
                t0 = time.perf_counter()
                split_host = 0.0
                if cfg.split == "bfs_host":
                    with span("engine.split_host"):
                        labels = split_bfs_host(graph, labels)
                    split_host = time.perf_counter() - t0
                t0 = time.perf_counter()
                with span("engine.compact"):
                    labels, k = _compact_host(labels)
                t_compact = time.perf_counter() - t0
                result = DetectionResult(
                    labels=labels, num_communities=k, backend=name,
                    lpa_iterations=int(run.lpa_iterations[i]),
                    split_iterations=int(run.split_iterations[i]),
                    timings={"prorated_prepare": t_prep * w,
                             "prorated_propagation": run.lpa_seconds * w,
                             "prorated_split": run.split_seconds * w,
                             "split": split_host, "compact": t_compact},
                    bucket=tuple(bucket), cache_hit=cache_hit,
                    warm_started=warm_r[i], device=str(self.device),
                    batch_size=len(graphs), batch_index=i,
                    profile=run.profile[i] if run.profile else None)
                if cfg.compute_metrics or cfg.quality == "full":
                    graph = graph.to(self.device)
                if cfg.compute_metrics:
                    self._attach_metrics(result, graph)
                if cfg.quality != "off":
                    self._attach_quality(result, graph, labels_r[i])
                results.append(result)
        self._m_batch_fits.inc()
        self._m_fits.inc(len(graphs))
        return results

    def _fit_resolved(self, graph: Graph, init_labels, init_active,
                      backend: str | None, warm_started: bool,
                      ) -> DetectionResult:
        cfg = self.config
        name = backend or cfg.backend
        if name == "auto":
            name = choose_backend(graph, cfg, self.device)
        be = get_backend(name)
        if not getattr(be, "rows_only", False):
            graph = graph.to(self.device)

        bucket = bucket_for(graph, bucketing=cfg.bucketing,
                            min_vertex_bucket=cfg.min_vertex_bucket,
                            min_edge_bucket=cfg.min_edge_bucket)
        key = (name, bucket, cfg.bucketing, cfg.algo_key(),
               be.plan_key(cfg), self.device)
        with span("engine.fit", backend=name, n=graph.n):
            with plan_context(name, bucket):
                plan, cache_hit = self.cache.get_or_build(
                    key, lambda: be.build(bucket, cfg, self.device))

            t0 = time.perf_counter()
            with span("engine.prepare"):
                inputs = be.prepare(graph, bucket, cfg)
                device_sync(self.device)
            t_prep = time.perf_counter() - t0

            with span("engine.dispatch"):
                run = be.run(plan, inputs, graph.n, init_labels,
                             init_active)
            labels = np.asarray(run.labels)[: graph.n]

            split_seconds = run.split_seconds
            if cfg.split == "bfs_host":
                t0 = time.perf_counter()
                with span("engine.split_host"):
                    labels = split_bfs_host(graph, labels)
                split_seconds += time.perf_counter() - t0

            t0 = time.perf_counter()
            with span("engine.compact"):
                labels, k = _compact_host(labels)
            t_compact = time.perf_counter() - t0

        self._m_fits.inc()
        result = DetectionResult(
            labels=labels, num_communities=k, backend=name,
            lpa_iterations=run.lpa_iterations,
            split_iterations=run.split_iterations,
            timings={"prepare": t_prep, "propagation": run.lpa_seconds,
                     "split": split_seconds, "compact": t_compact},
            bucket=tuple(bucket), cache_hit=cache_hit,
            warm_started=warm_started, device=str(self.device),
            profile=run.profile)
        if cfg.compute_metrics or cfg.quality == "full":
            graph = graph.to(self.device)
        if cfg.compute_metrics:
            self._attach_metrics(result, graph)
        if cfg.quality != "off":
            self._attach_quality(result, graph, init_labels)
        return result

    def _attach_metrics(self, result: DetectionResult, graph: Graph) -> None:
        from repro_torch.core.modularity import modularity
        labels = torch.from_numpy(result.labels).to(graph.device)
        result.modularity = float(modularity(graph, labels))
        result.check_connected(graph)

    def _attach_quality(self, result: DetectionResult, graph: Graph,
                        prev_labels) -> None:
        """The quality report of a fit (``EngineConfig.quality``), on its
        final labels after convergence.  ``prev_labels``: the resolved
        warm-start labels, the churn baseline (None on a cold fit).

        ``"basic"`` is host-only (sizes, count, churn); ``"full"`` adds
        ``check_connected`` (cached by fingerprint) and one modularity
        pass on the graph's device, unless ``compute_metrics`` paid them.
        ``graph=None`` gives the host-only report of an out-of-core fit.
        """
        from repro_torch.obs.quality import compute_quality, record_report
        mode = self.config.quality
        with span("engine.quality", mode=mode):
            full = mode == "full"
            if full and graph is not None:
                result.check_connected(graph)
            result.quality = compute_quality(
                result.labels, mode=mode, graph=graph if full else None,
                prev_labels=prev_labels,
                num_communities=result.num_communities,
                modularity=result.modularity,
                disconnected_fraction=result.disconnected_fraction)
            if result.modularity is None:
                result.modularity = result.quality.modularity
            record_report(self._q_obs, result.quality)

    def stats(self) -> dict:
        """Plan-cache observability (plans, hits, misses, builds per stage)
        and the warm cache's entries, capacity, hits, misses and
        evictions."""
        return {**self.cache.stats(), "plan_builds": PLAN_LOG.snapshot(),
                **self._warm.stats()}
