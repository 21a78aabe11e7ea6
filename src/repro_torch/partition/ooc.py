"""Out-of-core partitioned GSL-LPA: detect graphs bigger than memory.

``fit_out_of_core`` sweeps a
:class:`~repro_torch.partition.plan.PartitionPlan` one resident partition
at a time through a backend's partition hooks
(``segment`` / ``tile``: see their ``build_partition``), keeping only O(n)
vertex-indexed state resident on the host (the shared global label array,
active flags, ``row_ptr``) while the O(m) edge windows stream to the
device under a hard byte budget
(:class:`~repro_torch.partition.slices.MemoryLedger`).  Each visit's
sweep runs on the engine's device: on CUDA the tile backend launches B1 /
B2 (unfused) or B3 / B4 (fused) on the partition's tiles; the owned rows'
results come back through pinned buffers.

**Bit parity with the in-core fit is by construction.**  Every in-core
sweep (``lpa_move`` sub-sweeps and the Split-Last min-label sweeps) is
*synchronous*: new labels are a pure function of the pre-sweep label
snapshot.  So processing partitions one after another against that
snapshot (halo labels gathered from the shared global array) and
double-buffering the results reproduces the in-core sweep exactly,
whatever the partition count; the split phase converges to one label per
(community x component) through the outer fixed-point loop, which *is* the
cross-partition unification.  Three details make it exact:

* pruning reactivation is evaluated **lazily**: a sweep's wake mask
  depends on its final changed flags, complete only after the last
  partition, so each partition refreshes its own rows' active flags at the
  start of its *next* visit, from its own edge window (the rule reads each
  vertex's own neighborhood, so no second edge pass is needed);
* the pointer-jump shortcut gathers at arbitrary label values, so it runs
  as a global O(n) pass after each assembled split sweep, the position it
  has in the in-core sweep body;
* the convergence threshold has the in-core float semantics of each
  (backend, bucketing) combination.

The JAX package's ``repro.partition.ooc`` is the reference: the same plan,
sweeps, tie-break seeds ``2*it + sweep``, counters and spans.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

import repro_torch.engine.backends  # noqa: F401  (registers the backends)
from repro_torch.core.graph import _EDGE_ALIGN, _round_up
from repro_torch.engine.bucketing import next_pow2
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import resolve_device
from repro_torch.engine.registry import (
    _TILE_MAX_CELLS,
    _TILE_MAX_DEGREE,
    get_backend,
    to_device,
    to_host,
)
from repro_torch.kernels.ref import label_hash
from repro_torch.obs import REGISTRY, span
from repro_torch.obs.convergence import ConvergenceProfile, phase_from_rows
from repro_torch.partition.plan import (
    PartitionPlan,
    attach_halos,
    parse_bytes,
    plan_partitions,
)
from repro_torch.partition.slices import (
    HaloLabelCache,
    InMemorySource,
    MemoryLedger,
    PartitionShapes,
    SliceLoader,
    StoreEntrySource,
)

# In-core residency of one directed edge slot: src + dst + wgt + mask.
IN_CORE_EDGE_BYTES = 13

# Shared registry scope of every out-of-core fit in the process: its
# counters (``fits``, ``exchange_bytes``, the loader's and the ledger's)
# add up across fits, like the engine's warm-cache counters.
_OOC = REGISTRY.scope("ooc")


@dataclasses.dataclass
class OocRun:
    """Raw out-of-core run result + observability counters."""
    labels: np.ndarray            # (n,) int32, uncompacted global labels
    backend: str
    lpa_iterations: int
    split_iterations: int
    lpa_seconds: float
    split_seconds: float
    plan_seconds: float           # partitioning + halo scan + set-up
    num_partitions: int
    peak_resident_bytes: int
    budget: int
    halo_vertices: int            # total halo rows across partitions
    exchange_bytes: int           # label bytes gathered/scattered, all sweeps
    partition_loads: int          # slice loads actually paid (LRU misses)
    cache_hit: bool               # sweep plan came from the engine's cache
    plan_stats: dict
    fused: bool = False           # partition sweeps ran the fused kernels
    prefetches: int = 0           # windows staged on the prefetch worker
    prefetch_hits: int = 0        # loads served by a staged window
    halo_cache_bytes_saved: int = 0  # gather bytes skipped via label cache
    halo_cache_hits: int = 0      # partition visits with zero re-upload
    load_wait_seconds: float = 0.0  # waiting on window loads / joins
    profile: object | None = None  # ConvergenceProfile when cfg.profile on

    def stats(self) -> dict:
        return {
            "backend": self.backend, "partitions": self.num_partitions,
            "budget": self.budget,
            "peak_resident_bytes": self.peak_resident_bytes,
            "halo_vertices": self.halo_vertices,
            "exchange_bytes": self.exchange_bytes,
            "partition_loads": self.partition_loads,
            "lpa_iterations": self.lpa_iterations,
            "split_iterations": self.split_iterations,
            "fused": self.fused,
            "prefetches": self.prefetches,
            "prefetch_hits": self.prefetch_hits,
            "halo_cache_bytes_saved": self.halo_cache_bytes_saved,
            "halo_cache_hits": self.halo_cache_hits,
            "load_wait_seconds": self.load_wait_seconds,
            **{f"plan_{k}": v for k, v in self.plan_stats.items()},
        }


def open_source(graph, **load_kwargs):
    """Graph -> :class:`InMemorySource`; path -> store-backed windows.

    Paths go through :func:`repro_torch.io.store.open_graph`, which
    ingests on first contact and afterwards serves zero-copy windows off
    the store's map: the one path that never materializes the edge arrays.
    """
    from repro_torch.core.graph import Graph
    if isinstance(graph, Graph):
        return InMemorySource(graph)
    if isinstance(graph, str) or hasattr(graph, "__fspath__"):
        from repro_torch.io.store import open_graph
        return StoreEntrySource(open_graph(graph, **load_kwargs))
    raise TypeError(f"expected a Graph or a graph-file path, "
                    f"got {type(graph).__name__}")


def in_core_edge_bytes(source) -> int:
    """Edge-array bytes an in-core fit would hold resident."""
    return int(source.m_pad) * IN_CORE_EDGE_BYTES


def choose_partition_backend(d_bucket: int, n: int,
                             device: torch.device) -> str:
    """``auto`` out of core: the engine's policy (tile on CUDA under the
    degree and cell limits, else segment)."""
    if (torch.device(device).type == "cuda" and d_bucket <= _TILE_MAX_DEGREE
            and n * d_bucket <= _TILE_MAX_CELLS):
        return "tile"
    return "segment"


def _host_parity(n: int) -> np.ndarray:
    """The semi-synchronous sub-sweep classes, from the port's own hash
    (the function the in-core loops use, seed -1)."""
    return (label_hash(torch.arange(n, dtype=torch.int32), -1) & 1) \
        .bool().numpy()


def _host_threshold(n: int, tau: float, backend: str,
                    bucketing: str) -> int:
    """The in-core convergence threshold, bit for bit.

    The segment backend under ``exact`` bucketing takes ``tau * n`` in
    Python float; every other combination ``float32(tau) * float32(n)``.
    Both truncate toward zero.
    """
    if backend == "segment" and bucketing == "exact":
        return int(np.int32(tau * n))
    return int(np.int32(np.float32(tau) * np.float32(n)))


def _shapes_for(plan: PartitionPlan, bucketing: str) -> PartitionShapes:
    rows = next_pow2(plan.max_part_size, 8)
    n_loc = max(next_pow2(plan.max_n_local, 8), rows)
    m = max(_round_up(next_pow2(plan.max_part_edges), _EDGE_ALIGN),
            _EDGE_ALIGN)
    # the in-core tile width (engine/bucketing.py:bucket_for)
    d = plan.d_max if bucketing == "exact" else next_pow2(plan.d_max)
    return PartitionShapes(n_loc=n_loc, m=m, rows=rows, d=d)


def fit_out_of_core(source, config: EngineConfig | None = None, *,
                    memory_budget, backend: str | None = None,
                    cache=None, num_partitions: int | None = None,
                    init_labels: np.ndarray | None = None,
                    init_active: np.ndarray | None = None,
                    prefetch: bool | None = None,
                    halo_cache: bool = True, device=None) -> OocRun:
    """Detect communities with edge residency capped at ``memory_budget``.

    ``source``: an array source from :func:`open_source`.  ``config``: the
    usual :class:`EngineConfig` algorithm knobs (``split`` must run on the
    device: ``bfs_host`` needs the whole adjacency in host memory).
    ``cache``: optional engine :class:`PlanCache` for the partition sweep
    plans.  ``num_partitions`` overrides the budget-derived partition count
    (benchmarks); the byte budget stays enforced either way.  Warm starts
    (``init_labels`` / ``init_active``) behave as ``Engine.fit``'s: they are
    O(n) vertex state, which the semi-external model keeps resident
    anyway.  ``device``: where the sweeps run; defaults to
    ``config.device`` (``None`` is CUDA).

    ``prefetch`` stages partition ``k+1``'s window and device inputs on a
    worker thread while partition ``k`` sweeps (ledger-reserved before the
    thread starts); ``None`` turns it on exactly when a second CPU exists
    for the worker.  ``halo_cache`` (default on) keeps per-partition label
    views on the device and uploads only changed entries on re-visits.
    Both step back under budget pressure, and neither changes a label.

    Returns an :class:`OocRun` whose ``labels`` equal the in-core
    ``Engine.fit`` labels for the same (backend, config) bit for bit.
    """
    cfg = config if config is not None else EngineConfig()
    if cfg.split == "bfs_host":
        raise ValueError(
            "split='bfs_host' walks the full adjacency in host memory and "
            "cannot run out-of-core; use split='lp' or 'lpp'")
    budget = parse_bytes(memory_budget)
    dev = resolve_device(cfg.device if device is None else device)
    if prefetch is None:
        cores = (len(os.sched_getaffinity(0))
                 if hasattr(os, "sched_getaffinity")
                 else (os.cpu_count() or 1))
        prefetch = cores > 1

    t0 = time.perf_counter()
    row_ptr = np.asarray(source.row_ptr())
    n = int(source.n)
    degrees = row_ptr[1:] - row_ptr[:-1]
    d_real = int(degrees.max()) if n else 1
    d_bucket = next_pow2(max(d_real, 1))

    name = backend or cfg.backend
    if name == "auto":
        name = choose_partition_backend(d_bucket, n, dev)
    be = get_backend(name)
    if not getattr(be, "supports_partition", False):
        raise ValueError(f"backend {name!r} has no partition sweeps; "
                         "out-of-core fits support segment and tile")

    with span("ooc.plan", n=n, backend=name) as sp_plan:
        if num_partitions is not None:
            plan = plan_partitions(row_ptr, num_partitions=num_partitions)
        else:
            max_edges, max_vertices = be.partition_caps(budget, d_bucket)
            plan = plan_partitions(row_ptr, max_edges=max_edges,
                                   max_vertices=max_vertices)
        plan = attach_halos(plan,
                            lambda lo, hi: source.window("dst", lo, hi))
        shapes = _shapes_for(plan, cfg.bucketing)

        if cache is not None:
            key = ("partition", name, cfg.algo_key(), be.plan_key(cfg),
                   str(dev))
            sweeps, cache_hit = cache.get_or_build(
                key, lambda: be.build_partition(cfg, dev))
        else:
            sweeps, cache_hit = be.build_partition(cfg, dev), False
        sp_plan.set(partitions=plan.num_partitions,
                    halo_vertices=plan.halo_vertices, cache_hit=cache_hit)

    fused = sweeps.fuse

    ledger = MemoryLedger(budget, scope=_OOC)
    loader = SliceLoader(source, plan, ledger,
                         prefetch=prefetch and plan.num_partitions > 1,
                         scope=_OOC)
    prepare = _Prepare(be, shapes, cfg, dev)

    # Label caches on the device, one per global array so epochs never mix
    # (labels evolve per sub-sweep; comm is frozen during the split; slab
    # evolves per split sweep).  Registered as spillers: window loads
    # reclaim cache bytes before the ledger would fail.
    caches: list[HaloLabelCache] = []
    lab_cache = comm_cache = slab_cache = None
    if halo_cache:
        lab_cache, comm_cache, slab_cache = caches = [
            HaloLabelCache(ledger, n, shapes.n_loc, what, dev)
            for what in ("labels", "comm", "slab")]
        loader.spillers.extend(c.spill for c in caches)

    # --- resident O(n) vertex state (the semi-external model's half) ---
    labels = (np.arange(n, dtype=np.int32) if init_labels is None
              else np.asarray(init_labels, dtype=np.int32).copy())
    active = (np.ones(n, dtype=bool) if init_active is None
              else np.asarray(init_active, dtype=bool).copy())
    parity = _host_parity(n)
    threshold = _host_threshold(n, cfg.tau, name, cfg.bucketing)
    bound = n
    exchange = Exchange(shapes)
    t_plan = time.perf_counter() - t0

    def gather(cache, arr, res):
        """The cached local view when there is room, else a plain host
        gather uploaded to the device."""
        if cache is not None:
            out = cache.gather(res.part.index, res.local_ids, arr)
            if out is not None:
                return out
        return to_device(exchange.gather(arr, res.local_ids), dev)

    load_wait = 0.0

    def visit(i):
        """Load partition ``i`` and stage ``i+1`` behind it."""
        nonlocal load_wait
        t = time.perf_counter()
        res = loader.load(i, prepare)
        loader.prefetch((i + 1) % plan.num_partitions, prepare, keep=i)
        load_wait += time.perf_counter() - t
        return res

    zeros_loc = torch.zeros(shapes.n_loc, dtype=torch.bool, device=dev)
    ones_loc = torch.ones(shapes.n_loc, dtype=torch.bool, device=dev)

    # Profile rows are taken on the host at the loop's own sync points
    # (each visit's owned rows already come down), so profiling adds no
    # device read.
    do_profile = cfg.profile != "off"
    prop_rows: list[tuple[int, int, int]] = []
    split_rows: list[tuple[int, int, int]] = []
    try:
        # --- propagation: Algorithm 3 lines 1-6, partitioned ---
        t0 = time.perf_counter()
        changed_prev: np.ndarray | None = None
        klass_prev: np.ndarray | None = None
        it, delta = 0, n
        with span("ooc.propagation", backend=name) as sp_lpa:
            while delta > threshold and it < cfg.max_iterations:
                delta = 0
                for sweep in (0, 1):
                    klass = parity if sweep else ~parity
                    seed = 2 * it + sweep
                    labels_next = labels.copy()
                    changed_next = np.zeros(n, dtype=bool)
                    sweep_delta = 0
                    cand_count = 0
                    for i in range(plan.num_partitions):
                        res = visit(i)
                        part, rng = res.part, slice(res.part.lo,
                                                    res.part.hi)
                        lab_loc = gather(lab_cache, labels, res)
                        if fused:
                            # one launch: lazy active refresh + candidate
                            # pick + move
                            if changed_prev is not None:
                                chg_loc = to_device(exchange.gather(
                                    changed_prev, res.local_ids), dev)
                                candp = active[rng] & klass_prev[rng]
                            else:
                                chg_loc = zeros_loc
                                candp = np.zeros(part.size, dtype=bool)
                            new, act = be.partition_move_fused(
                                sweeps, res.inputs, lab_loc, chg_loc,
                                active[rng], candp, klass[rng], seed, bound)
                            new, act = to_host(new, part.size, act)
                            active[rng] = act[: part.size]
                            if do_profile:
                                # act is post-wake, pre-move: act & klass
                                # is the candidate set the kernel swept
                                cand_count += int(
                                    (active[rng] & klass[rng]).sum())
                        else:
                            if changed_prev is not None:
                                # lazy pruning update: finish the previous
                                # sweep's active refresh for this partition
                                wake = be.partition_wake(
                                    sweeps, res.inputs, to_device(
                                        exchange.gather(changed_prev,
                                                        res.local_ids),
                                        dev))
                                wake, = to_host(wake, part.size)
                                was_cand = active[rng] & klass_prev[rng]
                                active[rng] = (active[rng] & ~was_cand) \
                                    | wake
                            cand = active[rng] & klass[rng]
                            if do_profile:
                                cand_count += int(cand.sum())
                            new, = to_host(be.partition_move(
                                sweeps, res.inputs, lab_loc, cand, seed,
                                bound), part.size)
                        exchange.scatter(labels_next, rng, new)
                        ch = new != labels[rng]
                        changed_next[rng] = ch
                        sweep_delta += int(ch.sum())
                    delta += sweep_delta
                    if do_profile:
                        prop_rows.append((seed, cand_count, sweep_delta))
                    labels = labels_next
                    if lab_cache is not None:
                        lab_cache.advance(changed_next)
                    changed_prev, klass_prev = changed_next, klass
                it += 1
            sp_lpa.set(iterations=it, partitions=plan.num_partitions)
        lpa_iterations = it
        t_lpa = time.perf_counter() - t0

        # --- Split-Last, per partition, unified across partitions through
        # the shared global label array ---
        t0 = time.perf_counter()
        split_iterations = 0
        if cfg.split in ("lp", "lpp"):
            prune = cfg.split == "lpp"
            comm = labels                      # frozen community assignment
            slab = np.arange(n, dtype=np.int32)
            sactive = np.ones(n, dtype=bool)
            changed_prev = None
            delta = 1
            with span("ooc.split", backend=name) as sp_split:
                while delta > 0:
                    # frontier proxy: the split worklist is not built on
                    # the host (LP sweeps everyone; LPP wakes lazily in the
                    # visits), so the first sweep records n and later ones
                    # the previous sweep's changed count, the proxy of the
                    # fused in-core split profile.
                    active_proxy = n if changed_prev is None else delta
                    slab_next = slab.copy()
                    for i in range(plan.num_partitions):
                        res = visit(i)
                        part, rng = res.part, slice(res.part.lo,
                                                    res.part.hi)
                        comm_loc = gather(comm_cache, comm, res)
                        slab_loc = gather(slab_cache, slab, res)
                        if fused:
                            # one launch: lazy wake + same-community min
                            # (first sweep: everyone awake, chg all ones)
                            chg_loc = (to_device(exchange.gather(
                                changed_prev, res.local_ids), dev)
                                if changed_prev is not None else ones_loc)
                            new = be.partition_split_fused(
                                sweeps, res.inputs, comm_loc, slab_loc,
                                chg_loc, bound)
                        else:
                            if prune and changed_prev is not None:
                                wake = be.partition_split_wake(
                                    sweeps, res.inputs, comm_loc,
                                    to_device(exchange.gather(
                                        changed_prev, res.local_ids), dev))
                                sactive[rng], = to_host(wake, part.size)
                            new = be.partition_split(
                                sweeps, res.inputs, comm_loc, slab_loc,
                                sactive[rng], bound)
                        new, = to_host(new, part.size)
                        exchange.scatter(slab_next, rng, new)
                    if cfg.shortcut:
                        # global pointer jump, an O(n) vertex pass in the
                        # in-core sweep body's position
                        slab_next = np.minimum(slab_next,
                                               slab_next[slab_next])
                    changed = slab_next != slab
                    delta = int(changed.sum())
                    if cfg.profile == "full":
                        split_rows.append((split_iterations, active_proxy,
                                           delta))
                    changed_prev = changed
                    slab = slab_next
                    if slab_cache is not None:
                        slab_cache.advance(changed)
                    split_iterations += 1
                sp_split.set(iterations=split_iterations)
            labels = slab
        t_split = time.perf_counter() - t0
        peak = ledger.peak
    finally:
        for c in caches:
            c.drop()
        loader.clear()

    # Cached gathers bypass the Exchange accounting; fold the bytes the
    # caches did move (builds + changed-entry refreshes) back in, so
    # exchange_bytes stays "label traffic a wire layout would carry".
    exchange_bytes = exchange.bytes + sum(c.bytes for c in caches)
    profile = None
    if do_profile:
        profile = ConvergenceProfile(
            propagation=phase_from_rows("propagation", prop_rows),
            split=(phase_from_rows("split", split_rows)
                   if split_rows else None),
            n=n)
    _OOC.counter("fits").inc()
    _OOC.counter("exchange_bytes").inc(exchange_bytes)
    return OocRun(
        labels=labels, backend=name, lpa_iterations=lpa_iterations,
        split_iterations=split_iterations, lpa_seconds=t_lpa,
        split_seconds=t_split, plan_seconds=t_plan,
        num_partitions=plan.num_partitions, peak_resident_bytes=peak,
        budget=budget, halo_vertices=plan.halo_vertices,
        exchange_bytes=exchange_bytes, partition_loads=loader.loads,
        cache_hit=cache_hit, plan_stats=plan.stats(),
        fused=fused, prefetches=loader.prefetches,
        prefetch_hits=loader.prefetch_hits,
        halo_cache_bytes_saved=sum(c.bytes_saved for c in caches),
        halo_cache_hits=sum(c.hits for c in caches),
        load_wait_seconds=load_wait, profile=profile,
    )


def _tensors(inputs) -> list[torch.Tensor]:
    """The device tensors of a backend's partition inputs (a local Graph
    or a tuple of tiles)."""
    if isinstance(inputs, (tuple, list)):
        return list(inputs)
    return [getattr(inputs, f.name) for f in dataclasses.fields(inputs)
            if isinstance(getattr(inputs, f.name), torch.Tensor)]


class _Prepare:
    """The loader's adapter to the backend's device-side preparation.

    ``build`` runs on the calling thread, on the current stream.  ``stage``
    runs on the prefetch worker: on CUDA it uploads on a stream of its own
    and records an event after the copies; ``adopt``, back on the caller,
    makes the current stream wait on that event and marks every staged
    tensor as used by the current stream (``record_stream``), so no
    kernel reads a staged tile before its copy lands and the allocator
    does not reuse its memory while the current stream may still read it.
    """

    def __init__(self, backend, shapes: PartitionShapes,
                 config: EngineConfig, device: torch.device):
        self.backend, self.shapes, self.config = backend, shapes, config
        self.device = device
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" else None)

    def estimate(self, part) -> int:
        return self.backend.partition_prepare_nbytes(self.shapes)

    def build(self, resident):
        return self.backend.prepare_partition(resident, self.shapes,
                                              self.config, self.device)

    def stage(self, resident):
        if self._stream is None:
            return (*self.build(resident), None)
        with torch.cuda.stream(self._stream):
            inputs, nbytes = self.build(resident)
            done = torch.cuda.Event()
            done.record(self._stream)
        return inputs, nbytes, done

    def adopt(self, inputs, done) -> None:
        if done is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for t in _tensors(inputs):
            t.record_stream(current)


class Exchange:
    """Per-sweep halo-label gather/scatter on the host, with byte
    accounting.

    ``gather`` pulls a partition's local view (owned rows, then halo
    imports) out of a shared global array, padded to the run's local
    length; ``scatter`` writes the owned rows back.  The byte count is the
    label traffic a multi-process layout would put on the wire
    (``OocRun.exchange_bytes``).
    """

    def __init__(self, shapes: PartitionShapes):
        self.shapes = shapes
        self.bytes = 0

    def gather(self, global_arr: np.ndarray, local_ids: np.ndarray,
               ) -> np.ndarray:
        out = np.zeros(self.shapes.n_loc, dtype=global_arr.dtype)
        out[: len(local_ids)] = global_arr[local_ids]
        self.bytes += int(len(local_ids)) * global_arr.itemsize
        return out

    def scatter(self, global_arr: np.ndarray, rng: slice,
                values: np.ndarray) -> None:
        global_arr[rng] = values
        self.bytes += values.nbytes
