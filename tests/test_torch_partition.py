"""PyTorch port, out-of-core partitioned detection (``repro_torch.partition``)
against the JAX package's ``repro.partition`` on the same inputs.

* Plans, halos, ``parse_bytes`` and ``load_partition`` arrays equal the
  reference's for the same ``row_ptr`` / windows.
* The ledger's budget is hard; the loader's LRU and prefetch stay under
  it; the halo label cache refreshes only stale entries.
* Out-of-core fits give the labels and iteration counts of the reference's
  out-of-core fit and of the port's in-core fit, for segment and tile,
  every split, fusion, prefetch and halo cache on and off, warm starts,
  the segment path's shortcut with real weights, a store path and the
  ingest CLI; profiles equal the in-core curves; quality is host-only;
  the ``ooc.*`` spans and the ``ooc`` scope's counters are written.

Graphs carry integer weights unless a test says otherwise.  The port runs
with ``device="cpu"``, where its kernels take their plain versions.  Each
reference fit is computed once per module (``REF``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import random_graph  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.partition import ooc as jooc  # noqa: E402
from repro.partition import plan as jplan  # noqa: E402
from repro.partition import slices as jslices  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.partition import ooc, plan, slices  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()
REF: dict = {}   # reference outputs, computed once per module


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def memo(key, make):
    if key not in REF:
        REF[key] = make()
    return REF[key]


GRAPHS = {
    "random": lambda: random_graph(220, 4.0, seed=3),
    "communities": lambda: jgen.planted_partition(8, 24, 0.3, 0.01,
                                                  seed=4)[0],
    "tile_mix": lambda: random_graph(256, 10.0, seed=21),
}


def graph(name):
    return memo(("graph", name), GRAPHS[name])


def tight_budget(g, backend="segment"):
    """Under the in-core edge bytes, so the fit must partition.  The
    reference's tile backend has a floor of one (8, 128)-cell tile; the
    port's tiles are the in-core width, so half the bytes cut it."""
    in_core = g.m_pad * ooc.IN_CORE_EDGE_BYTES
    return in_core // 2 if backend == "tile" else in_core // 3


def ref_budget(g, backend):
    in_core = g.m_pad * jooc.IN_CORE_EDGE_BYTES
    return max(in_core // 2, 20_000) if backend == "tile" else in_core // 3


def cpu_engine(**cfg):
    return Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache())


def row_ptr_of(g):
    return np.asarray(g.row_ptr)


def assert_same_fit(want, got, ctx):
    assert np.array_equal(want.labels, got.labels), ctx
    assert want.lpa_iterations == got.lpa_iterations, ctx
    assert want.split_iterations == got.split_iterations, ctx


# --- planning -------------------------------------------------------------

@pytest.mark.parametrize("n,deg,seed,kw", [
    (300, 5.0, 0, dict(num_partitions=7)),
    (200, 6.0, 1, dict(max_edges=100)),
    (200, 6.0, 1, dict(max_edges=10 ** 9, max_vertices=16)),
    (150, 5.0, 2, dict(num_partitions=5)),
    (120, 4.0, 5, dict(num_partitions=4)),
    (40, 2.0, 9, dict(num_partitions=100)),
])
def test_plan_and_halos_match_reference(n, deg, seed, kw):
    g = random_graph(n, deg, seed=seed)
    rp = row_ptr_of(g)
    dst = np.asarray(g.dst)
    want = jplan.attach_halos(jplan.plan_partitions(rp, **kw),
                              lambda lo, hi: dst[lo:hi])
    got = plan.attach_halos(plan.plan_partitions(rp, **kw),
                            lambda lo, hi: dst[lo:hi])
    assert (got.n, got.num_edges, got.d_max) \
        == (want.n, want.num_edges, want.d_max)
    assert got.num_partitions == want.num_partitions
    for a, b in zip(got.parts, want.parts):
        assert (a.index, a.lo, a.hi, a.e_lo, a.e_hi) \
            == (b.index, b.lo, b.hi, b.e_lo, b.e_hi)
        assert a.halo.dtype == b.halo.dtype
        assert np.array_equal(a.halo, b.halo)
        assert np.array_equal(a.local_ids(), b.local_ids())
    assert got.stats() == want.stats()


def test_plan_covers_and_balances():
    g = random_graph(300, 5.0, seed=0)
    p = plan.plan_partitions(row_ptr_of(g), num_partitions=7)
    rp = row_ptr_of(g)
    assert p.parts[0].lo == 0 and p.parts[-1].hi == g.n
    for a, b in zip(p.parts[:-1], p.parts[1:]):
        assert a.hi == b.lo
    for part in p.parts:
        assert part.e_lo == rp[part.lo] and part.e_hi == rp[part.hi]
    target = -(-p.num_edges // p.num_partitions)
    assert p.max_part_edges <= target + int(np.max(rp[1:] - rp[:-1]))


def test_plan_by_max_edges_and_row_cap():
    g = random_graph(200, 6.0, seed=1)
    rp = row_ptr_of(g)
    d_max = int(np.max(rp[1:] - rp[:-1]))
    p = plan.plan_partitions(rp, max_edges=100)
    assert all(part.num_edges <= 100 + d_max for part in p.parts)
    capped = plan.plan_partitions(rp, max_edges=10 ** 9, max_vertices=16)
    assert all(part.size <= 16 for part in capped.parts)
    with pytest.raises(ValueError):
        plan.plan_partitions(rp)
    with pytest.raises(ValueError):
        plan.plan_partitions(rp, max_edges=10, num_partitions=3)
    with pytest.raises(ValueError):
        plan.plan_partitions(np.zeros(1, np.int32), num_partitions=1)


def test_halo_exactly_covers_cross_partition_edges():
    g = random_graph(150, 5.0, seed=2)
    src = np.asarray(g.src)[: g.num_edges]
    dst = np.asarray(g.dst)[: g.num_edges]
    p = plan.attach_halos(plan.plan_partitions(row_ptr_of(g),
                                               num_partitions=5),
                          lambda lo, hi: dst[lo:hi])
    for part in p.parts:
        in_part = (src >= part.lo) & (src < part.hi)
        crossing = dst[in_part & ((dst < part.lo) | (dst >= part.hi))]
        assert set(part.halo.tolist()) == set(crossing.tolist())
        assert np.all(np.diff(part.halo) > 0)
        assert not np.any((part.halo >= part.lo) & (part.halo < part.hi))


@pytest.mark.parametrize("text", [4096, np.int64(7), "64MB", "1GiB", "1Gi",
                                  "2.5KB", "12KB", " 3 mib ", "10", "1T"])
def test_parse_bytes_matches_reference(text):
    assert plan.parse_bytes(text) == jplan.parse_bytes(text)


@pytest.mark.parametrize("bad", ["sixty MB", "64XB", "1i", "", "-5MB"])
def test_parse_bytes_rejects_what_reference_rejects(bad):
    with pytest.raises(ValueError):
        jplan.parse_bytes(bad)
    with pytest.raises(ValueError, match="byte size"):
        plan.parse_bytes(bad)


# --- slices + ledger ------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4, 9])
def test_load_partition_matches_reference(parts):
    g = random_graph(120, 4.0, seed=5)
    jsrc = jslices.InMemorySource(g)
    tsrc = slices.InMemorySource(port_of(g))
    p = plan.attach_halos(
        plan.plan_partitions(row_ptr_of(g), num_partitions=parts),
        lambda lo, hi: tsrc.window("dst", lo, hi))
    src = np.asarray(g.src)[: g.num_edges]
    dst = np.asarray(g.dst)[: g.num_edges]
    for part in p.parts:
        want = jslices.load_partition(jsrc, part)
        got = slices.load_partition(tsrc, part)
        for f in ("local_ids", "row_ptr", "src", "dst", "wgt"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.nbytes == want.nbytes == slices.slice_nbytes(part)
        # local ids map back to exactly the window's global edges
        assert np.array_equal(got.local_ids[got.src],
                              src[part.e_lo:part.e_hi])
        assert np.array_equal(got.local_ids[got.dst],
                              dst[part.e_lo:part.e_hi])
        assert got.row_ptr[0] == 0 and got.row_ptr[-1] == part.num_edges


def test_load_partition_needs_halos():
    g = random_graph(60, 3.0, seed=5)
    p = plan.plan_partitions(row_ptr_of(g), num_partitions=2)
    with pytest.raises(ValueError, match="attach_halos"):
        slices.load_partition(slices.InMemorySource(port_of(g)), p.parts[0])


def test_ledger_budget_is_hard():
    ledger = slices.MemoryLedger(1000)
    ledger.acquire(800, "a")
    with pytest.raises(slices.MemoryBudgetExceeded):
        ledger.acquire(300, "b")
    ledger.acquire(200, "b")
    ledger.release(1000)
    assert ledger.current == 0 and ledger.peak == 1000
    assert ledger.stats() == {"budget": 1000, "current": 0, "peak": 1000}


def test_ledger_mirrors_a_registry_scope():
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    led = slices.MemoryLedger(1000, scope=reg.scope("t"))
    led.acquire(600)
    led.release(100)
    snap = reg.snapshot()
    assert (snap["t.bytes_budget"], snap["t.bytes_current"],
            snap["t.bytes_peak"]) == (1000, 500, 600)


def _loader_case(prefetch):
    g = random_graph(200, 5.0, seed=6)
    source = slices.InMemorySource(port_of(g))
    p = plan.attach_halos(plan.plan_partitions(row_ptr_of(g),
                                               num_partitions=6),
                          lambda lo, hi: source.window("dst", lo, hi))
    budget = max(slices.slice_nbytes(part) for part in p.parts) * 2
    ledger = slices.MemoryLedger(budget)
    return p, budget, ledger, slices.SliceLoader(source, p, ledger,
                                                 prefetch=prefetch)


def test_loader_lru_stays_under_budget():
    p, budget, ledger, loader = _loader_case(prefetch=False)
    for _sweep in range(3):
        for i in range(p.num_partitions):
            assert loader.load(i).part.index == i
    assert ledger.peak <= budget
    assert loader.loads > p.num_partitions  # tight budget => reloads
    assert loader.requests == 3 * p.num_partitions
    loader.clear()
    assert ledger.current == 0


def test_loader_prefetch_stages_under_budget():
    p, budget, ledger, loader = _loader_case(prefetch=True)
    for _sweep in range(2):
        for i in range(p.num_partitions):
            loader.load(i)
            loader.prefetch((i + 1) % p.num_partitions, keep=i)
    assert ledger.peak <= budget
    assert loader.prefetches > 0 and loader.prefetch_hits > 0
    loader.clear()                      # joins + releases staged windows
    assert ledger.current == 0


def test_halo_label_cache_epoch_invalidation():
    ledger = slices.MemoryLedger(1 << 20)
    arr = (np.arange(100, dtype=np.int32) * 10).copy()
    cache = slices.HaloLabelCache(ledger, n=100, n_loc=16, what="labels")
    ids = np.array([5, 7, 50, 99])
    v1 = cache.gather(0, ids, arr).clone()
    assert isinstance(v1, torch.Tensor) and v1.shape == (16,)
    assert np.array_equal(v1.numpy()[:4], arr[ids])
    assert cache.hits == 0 and cache.bytes == 4 * arr.itemsize
    v2 = cache.gather(0, ids, arr)      # unchanged revisit: a pure hit
    assert cache.hits == 1 and torch.equal(v2, v1)
    assert cache.bytes == 4 * arr.itemsize
    arr[50] = -1                        # the owner of vertex 50 relabels it
    changed = np.zeros(100, dtype=bool)
    changed[50] = True
    cache.advance(changed)
    v3 = cache.gather(0, ids, arr).numpy()
    assert v3[2] == -1
    assert np.array_equal(v3[[0, 1, 3]], v1.numpy()[[0, 1, 3]])
    assert cache.hits == 1              # a refresh visit is not a hit
    assert cache.bytes == 5 * arr.itemsize          # 4 initial + 1 stale
    assert cache.bytes_saved == (4 + 3) * arr.itemsize
    cache.drop()
    assert ledger.current == 0


def test_halo_label_cache_respects_budget():
    arr = np.arange(32, dtype=np.int32)
    tiny = slices.HaloLabelCache(slices.MemoryLedger(32), n=32, n_loc=16)
    assert tiny.gather(0, np.array([1, 2]), arr) is None
    ledger = slices.MemoryLedger(160)   # room for two 64 B entries
    cache = slices.HaloLabelCache(ledger, n=32, n_loc=16)
    for idx in range(3):                # third insert evicts LRU entry 0
        assert cache.gather(idx, np.array([idx]), arr) is not None
    assert cache.stats()["entries"] == 2 and ledger.peak <= 160
    assert cache.spill(64) == 64
    assert cache.stats()["entries"] == 1


def test_single_partition_too_big_raises():
    g = port_of(random_graph(100, 5.0, seed=7))
    with pytest.raises(slices.MemoryBudgetExceeded):
        ooc.fit_out_of_core(ooc.open_source(g),
                            EngineConfig(backend="segment", device="cpu"),
                            memory_budget=64, num_partitions=2)


# --- the label_bound sentinel ---------------------------------------------

def test_min_label_sweep_label_bound_on_a_local_slice():
    """A partition's local rows carry global labels at or above the local
    row count.  With the whole graph's vertex count as the bound the sweep
    equals the reference's; with ``n_loc`` as the bound a vertex whose
    label is >= n_loc and that has a neighbor in another community drops
    to n_loc, a label of no vertex in its component."""
    from repro.core.graph import Graph as JGraph
    from repro.core.split import min_label_sweep as jsweep
    from repro_torch.core.split import min_label_sweep
    # local slice: rows 0-1 owned, row 2 a halo import; edges 0-1, 0-2
    src = np.array([0, 0, 1, 0, 0, 0, 0, 0], np.int32)
    dst = np.array([1, 2, 0, 0, 0, 0, 0, 0], np.int32)
    mask = np.array([1, 1, 1, 0, 0, 0, 0, 0], bool)
    wgt = mask.astype(np.float32)
    row_ptr = np.array([0, 2, 3, 3], np.int32)
    n_loc, n_global = 3, 1000
    comm = np.array([7, 9, 7], np.int32)     # 0 and 2 share a community
    labels = np.array([500, 600, 700], np.int32)
    active = np.ones(n_loc, bool)

    jg = JGraph(n=n_loc, m_pad=8, num_edges=8, row_ptr=row_ptr, src=src,
                dst=dst, wgt=wgt, edge_mask=mask,
                kdeg=np.zeros(n_loc, np.float32))
    want = np.asarray(jsweep(jg, comm, labels, active, n_global))
    tg = tgraph.graph_from_arrays(n_loc, 3, row_ptr, src, dst, wgt, mask,
                                  np.zeros(n_loc, np.float32))
    t = {k: torch.from_numpy(v) for k, v in
         (("comm", comm), ("labels", labels), ("active", active))}
    got = min_label_sweep(tg, t["comm"], t["labels"], t["active"], n_global)
    assert np.array_equal(got.numpy(), want)
    assert want.tolist() == [500, 600, 700]   # halo row 2 has no edges
    wrong = min_label_sweep(tg, t["comm"], t["labels"], t["active"], n_loc)
    assert not np.array_equal(wrong.numpy(), want)
    assert wrong.numpy()[0] == n_loc


def test_min_label_wake_matches_reference():
    from repro.core.split import min_label_wake as jwake
    from repro_torch.core.split import min_label_wake
    g = random_graph(80, 4.0, seed=4)
    rng = np.random.default_rng(4)
    comm = rng.integers(0, 5, g.n).astype(np.int32)
    changed = rng.random(g.n) < 0.2
    want = np.asarray(jwake(g, comm, changed))
    got = min_label_wake(port_of(g), torch.from_numpy(comm),
                         torch.from_numpy(changed))
    assert np.array_equal(got.numpy(), want)


# --- bit parity with the reference and the in-core engine -----------------

def ref_ooc_fit(name, backend, **cfg):
    def make():
        g = graph(name)
        eng = JEngine(JConfig(backend=backend, **cfg), cache=JAX_CACHE)
        return eng.fit(g, memory_budget=ref_budget(g, backend))
    return memo(("fit", name, backend, tuple(sorted(cfg.items()))), make)


PARITY = [("segment", "random"), ("segment", "communities"),
          ("tile", "tile_mix")]


@pytest.mark.parametrize("backend,name", PARITY)
@pytest.mark.parametrize("split", ["lp", "lpp", "none"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_ooc_fit_matches_reference_and_in_core(backend, name, split, fuse):
    g = graph(name)
    pg = port_of(g)
    budget = tight_budget(g, backend)
    eng = cpu_engine(backend=backend, split=split, fuse_sweeps=fuse)
    incore = eng.fit(pg)
    got = eng.fit(pg, memory_budget=budget)
    want = ref_ooc_fit(name, backend, split=split, fuse_sweeps=fuse)
    ctx = (backend, name, split, fuse)
    assert got.partitions > 1 and want.partitions > 1, ctx
    assert_same_fit(want, got, ctx)
    assert_same_fit(incore, got, ctx)
    assert got.num_communities == want.num_communities
    assert got.backend == backend and got.device == "cpu"
    assert got.ooc["fused"] == (fuse == "on")
    assert got.ooc["peak_resident_bytes"] <= budget
    if split != "none":
        assert got.check_connected(pg) == 0.0


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("halo_cache", [False, True])
@pytest.mark.parametrize("backend,name", [("segment", "random"),
                                          ("tile", "tile_mix")])
def test_ooc_prefetch_and_halo_cache_keep_labels(prefetch, halo_cache,
                                                 backend, name):
    g = graph(name)
    source = ooc.open_source(port_of(g))
    budget = tight_budget(g, backend)
    for fuse in ("on", "off"):
        cfg = EngineConfig(backend=backend, split="lpp", fuse_sweeps=fuse,
                           device="cpu")
        run = ooc.fit_out_of_core(source, cfg, memory_budget=budget,
                                  prefetch=prefetch, halo_cache=halo_cache)
        want = ref_ooc_fit(name, backend, split="lpp", fuse_sweeps=fuse)
        _, k = np.unique(run.labels, return_inverse=True)
        assert np.array_equal(k, want.labels)
        assert (run.lpa_iterations, run.split_iterations) \
            == (want.lpa_iterations, want.split_iterations)
        assert run.num_partitions > 1
        assert run.peak_resident_bytes <= budget
        if not prefetch:
            assert run.prefetches == 0
        if not halo_cache:
            assert run.halo_cache_hits == run.halo_cache_bytes_saved == 0


@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_ooc_prefetch_and_halo_cache_engage(backend):
    """With headroom over the windows, staged loads are adopted and the
    halo label cache serves revisits without re-gathering."""
    g = port_of(graph("random"))
    source = ooc.open_source(g)
    budget = 3 * ooc.in_core_edge_bytes(source)
    run = ooc.fit_out_of_core(
        source, EngineConfig(backend=backend, split="lp", device="cpu"),
        memory_budget=budget, num_partitions=4, prefetch=True,
        halo_cache=True)
    assert run.num_partitions == 4
    assert run.prefetches > 0 and run.prefetch_hits > 0
    assert run.halo_cache_hits > 0 and run.halo_cache_bytes_saved > 0
    assert run.peak_resident_bytes <= budget
    incore = cpu_engine(backend=backend, split="lp").fit(g)
    _, k = np.unique(run.labels, return_inverse=True)
    assert np.array_equal(k, incore.labels)


@pytest.mark.parametrize("case", ["shortcut_lpp", "exact", "real_weights",
                                  "real_weights_shortcut"])
def test_ooc_segment_shortcut_exact_real_weights(case):
    """The segment path: the shortcut as a global pointer jump, exact
    bucketing's Python-float threshold, and float32 real weights whose
    run sums fold in index order, all bit for bit."""
    if case.startswith("real_weights"):
        rng = np.random.default_rng(9)
        e = rng.integers(0, 150, size=(400, 2))
        g = memo(("graph", "weighted"), lambda: jbuild(
            e, rng.uniform(0.1, 5.0, size=400), n=150))
    else:
        g = memo(("graph", "r180"), lambda: random_graph(180, 4.0, seed=8))
    cfg = {"shortcut_lpp": dict(split="lpp", shortcut=True),
           "exact": dict(bucketing="exact"), "real_weights": {},
           "real_weights_shortcut": dict(shortcut=True)}[case]
    pg = port_of(g)
    budget = tight_budget(g)
    eng = cpu_engine(backend="segment", **cfg)
    got = eng.fit(pg, memory_budget=budget)
    assert got.partitions > 1
    assert_same_fit(eng.fit(pg), got, case)
    want = memo(("fit", case), lambda: JEngine(
        JConfig(backend="segment", **cfg), cache=JAX_CACHE).fit(
            g, memory_budget=budget))
    assert_same_fit(want, got, case)


def test_ooc_warm_start_parity():
    g = random_graph(200, 4.0, seed=10)
    pg = port_of(g)
    eng = cpu_engine(backend="segment")
    base = eng.fit(pg).labels
    frontier = np.zeros(g.n, bool)
    frontier[:40] = True
    incore = eng.fit(pg, init_labels=base, init_active=frontier)
    got = eng.fit(pg, init_labels=base, init_active=frontier,
                  memory_budget=tight_budget(g))
    jeng = JEngine(JConfig(backend="segment"), cache=JAX_CACHE)
    want = jeng.fit(g, init_labels=base, init_active=frontier,
                    memory_budget=tight_budget(g))
    assert incore.warm_started and got.warm_started and want.warm_started
    assert got.partitions > 1
    assert_same_fit(incore, got, "warm")
    assert_same_fit(want, got, "warm")
    with pytest.raises(ValueError, match="init_labels"):
        eng.fit(pg, init_labels=base[:-1], memory_budget=tight_budget(g))


def test_ooc_warm_start_auto_through_the_fingerprint():
    pg = port_of(graph("random"))
    budget = tight_budget(graph("random"))
    eng = cpu_engine(backend="segment", warm_start="auto")
    first = eng.fit(pg, memory_budget=budget)
    second = eng.fit(pg, memory_budget=budget)
    assert not first.warm_started and second.warm_started
    want = cpu_engine(backend="segment").fit(pg, init_labels=first.labels)
    assert_same_fit(want, second, "auto warm")
    assert eng.stats()["warm_hits"] == 1


# --- engine routing + guards ----------------------------------------------

def test_engine_routes_by_budget():
    g = random_graph(200, 4.0, seed=11)
    pg = port_of(g)
    eng = cpu_engine(backend="segment")
    small = eng.fit(pg, memory_budget=tight_budget(g))
    assert small.partitions > 1 and small.ooc is not None
    assert set(small.timings) == {"prepare", "propagation", "split",
                                  "compact"}
    big = eng.fit(pg, memory_budget="1GB")
    assert big.partitions == 1 and big.ooc is None
    assert np.array_equal(small.labels, big.labels)
    eng2 = cpu_engine(backend="segment", memory_budget=tight_budget(g))
    assert eng2.config.memory_budget == tight_budget(g)
    assert eng2.fit(pg).partitions > 1


def test_ooc_guards():
    pg = port_of(random_graph(120, 4.0, seed=12))
    budget = tight_budget(random_graph(120, 4.0, seed=12))
    with pytest.raises(ValueError, match="bfs_host"):
        cpu_engine(backend="segment", split="bfs_host").fit(
            pg, memory_budget=budget)
    with pytest.raises(ValueError, match="compute_metrics"):
        cpu_engine(backend="segment", compute_metrics=True).fit(
            pg, memory_budget=budget)
    with pytest.raises(ValueError, match="partition"):
        cpu_engine().fit(pg, backend="sharded", memory_budget=budget)
    with pytest.raises(ValueError, match="memory_budget"):
        EngineConfig(device="cpu", memory_budget=0)
    with pytest.raises(ValueError, match="byte size"):
        EngineConfig(device="cpu", memory_budget="lots")
    assert EngineConfig(device="cpu",
                        memory_budget="64MB").memory_budget == 64_000_000


def test_ooc_auto_backend_on_the_cpu_is_segment():
    g = port_of(graph("random"))
    run = ooc.fit_out_of_core(ooc.open_source(g),
                              EngineConfig(device="cpu"),
                              memory_budget=tight_budget(graph("random")))
    assert run.backend == "segment"
    cuda = torch.device("cuda")
    assert ooc.choose_partition_backend(4, 100, cuda) == "tile"
    assert ooc.choose_partition_backend(2048, 100, cuda) == "segment"
    assert ooc.choose_partition_backend(4, 1 << 23, cuda) == "segment"


def test_ooc_sweeps_share_plans():
    """A second out-of-core fit of the same config builds no plan."""
    from repro_torch.engine import PLAN_LOG
    g = port_of(random_graph(200, 4.0, seed=13))
    budget = tight_budget(random_graph(200, 4.0, seed=13))
    eng = cpu_engine(backend="segment")
    first = eng.fit(g, memory_budget=budget)
    builds = PLAN_LOG.snapshot().get("segment:partition", 0)
    second = eng.fit(g, memory_budget=budget)
    assert first.partitions > 1 and second.cache_hit
    assert PLAN_LOG.snapshot()["segment:partition"] == builds


def test_host_threshold_and_parity_match_reference():
    for n in (1, 37, 220, 4097):
        assert np.array_equal(ooc._host_parity(n), jooc._host_parity(n))
        for backend in ("segment", "tile"):
            for bucketing in ("pow2", "exact"):
                assert ooc._host_threshold(n, 0.05, backend, bucketing) \
                    == jooc._host_threshold(n, 0.05, backend, bucketing)


# --- store-backed path ----------------------------------------------------

def _snap_file(tmp_path, seed, n, m):
    from repro.io.formats import write_snap
    rng = np.random.default_rng(seed)
    path = tmp_path / "g.snap.txt"
    write_snap(path, rng.integers(0, n, size=(m, 2)))
    return path


def test_ooc_from_store_path(tmp_path, monkeypatch):
    from repro_torch.io.store import EntryHandle
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path / "cache"))
    path = _snap_file(tmp_path, 14, 300, 800)
    eng = cpu_engine(backend="segment")
    incore = eng.fit(str(path))

    def no_full_graph(self):
        raise AssertionError("the out-of-core path built the full graph")

    monkeypatch.setattr(EntryHandle, "to_graph", no_full_graph)
    got = eng.fit(str(path), memory_budget="12KB")
    assert got.partitions > 1
    assert_same_fit(incore, got, "store")
    assert got.ooc["peak_resident_bytes"] <= plan.parse_bytes("12KB")
    want = JEngine(JConfig(backend="segment"), cache=JAX_CACHE).fit(
        str(path), memory_budget="12KB")
    assert_same_fit(want, got, "store vs reference")
    source = ooc.open_source(str(path))
    assert source.n == incore.labels.shape[0]
    assert ooc.in_core_edge_bytes(source) > plan.parse_bytes("12KB")
    win = source.window("dst", 10, 60)
    assert win.base is not None           # a view of the entry's map


def test_ingest_cli_ooc(tmp_path, monkeypatch, capsys):
    from repro_torch.launch.ingest import main
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path / "cache"))
    path = _snap_file(tmp_path, 16, 200, 500)
    out_json = tmp_path / "report.json"
    assert main([str(path), "--ooc", "--memory-budget", "16KB",
                 "--backend", "segment", "--device", "cpu", "--cache-dir",
                 str(tmp_path / "cache"), "--json", str(out_json)]) == 0
    text = capsys.readouterr().out
    assert "ooc[segment]" in text and "partitions=" in text
    rep = json.loads(out_json.read_text())[0]
    assert rep["ooc"]["partitions"] > 1
    assert rep["ooc"]["peak_resident_bytes"] <= plan.parse_bytes("16KB")
    incore = cpu_engine(backend="segment").fit(str(path))
    assert rep["ooc"]["communities"] == incore.num_communities
    assert (rep["ooc"]["lpa_iterations"], rep["ooc"]["split_iterations"]) \
        == (incore.lpa_iterations, incore.split_iterations)
    with pytest.raises(SystemExit, match="no-cache"):
        main([str(path), "--ooc", "--no-cache", "--device", "cpu"])


# --- observability --------------------------------------------------------

@pytest.mark.parametrize("backend,fuse", [("segment", "auto"),
                                          ("segment", "off"),
                                          ("tile", "on"), ("tile", "off")])
def test_profile_ooc_bit_parity(backend, fuse):
    g = memo(("graph", "er200"), lambda: jgen.erdos_renyi(200, 6.0, seed=11))
    pg = port_of(g)
    src = ooc.open_source(pg)
    runs = {}
    for mode in ("off", "convergence", "full"):
        cfg = EngineConfig(backend=backend, split="lp", profile=mode,
                           fuse_sweeps=fuse, device="cpu")
        runs[mode] = ooc.fit_out_of_core(src, cfg, memory_budget="1MB",
                                         num_partitions=3)
    base = runs["off"]
    assert base.profile is None
    for mode in ("convergence", "full"):
        r = runs[mode]
        assert np.array_equal(r.labels, base.labels)
        assert (r.lpa_iterations, r.split_iterations) \
            == (base.lpa_iterations, base.split_iterations)
        assert r.profile.propagation.num_sub_sweeps == 2 * r.lpa_iterations
    assert runs["convergence"].profile.split is None
    assert runs["full"].profile.split is not None
    # the out-of-core propagation curve is the in-core one, exactly
    incore = cpu_engine(backend=backend, split="lp", profile="full",
                        fuse_sweeps=fuse).fit(pg)
    for col in ("sweep", "active", "changed"):
        assert np.array_equal(getattr(runs["full"].profile.propagation, col),
                              getattr(incore.profile.propagation, col)), col
    # and the reference's out-of-core curves, split proxy included
    want = memo(("profile", backend, fuse), lambda: jooc.fit_out_of_core(
        jooc.open_source(g), JConfig(backend=backend, split="lp",
                                     profile="full", fuse_sweeps=fuse),
        memory_budget="1MB", num_partitions=3, cache=JAX_CACHE))
    for phase in ("propagation", "split"):
        a = getattr(runs["full"].profile, phase)
        b = getattr(want.profile, phase)
        for col in ("sweep", "active", "changed"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), \
                (phase, col)


@pytest.mark.parametrize("mode", ["basic", "full"])
def test_quality_ooc_is_host_only(mode):
    g = memo(("graph", "er300"), lambda: jgen.erdos_renyi(300, 6.0,
                                                          seed=11))
    pg = port_of(g)
    ref = cpu_engine().fit(pg, memory_budget="4KB")
    r = cpu_engine(quality=mode).fit(pg, memory_budget="4KB")
    assert ref.partitions > 1 and r.partitions == ref.partitions
    assert_same_fit(ref, r, mode)
    assert r.quality.mode == mode
    assert r.quality.modularity is None
    assert r.quality.disconnected_fraction is None
    assert r.quality.num_communities == r.num_communities
    want = JEngine(JConfig(quality=mode), cache=JAX_CACHE).fit(
        g, memory_budget="4KB")
    assert want.quality.num_communities == r.quality.num_communities
    assert want.quality.size_max == r.quality.size_max


def test_ooc_spans_and_registry_counters(tmp_path):
    from repro_torch.obs import REGISTRY, TRACER
    g = port_of(jgen.erdos_renyi(150, 5.0, seed=9))
    TRACER.reset()
    r = cpu_engine(split="lp").fit(g, memory_budget="4KB")
    assert r.partitions > 1
    names = {s.name for s in TRACER.spans()}
    assert {"engine.fit_ooc", "ooc.plan", "ooc.propagation",
            "ooc.split"} <= names
    out = tmp_path / "ooc_trace.json"
    assert TRACER.export_chrome(out) >= 4
    events = [e for e in json.loads(out.read_text())
              if e["name"].startswith("ooc.")]
    assert {e["name"] for e in events} \
        >= {"ooc.plan", "ooc.propagation", "ooc.split"}
    run = ooc.fit_out_of_core(ooc.open_source(g),
                              EngineConfig(split="lp", device="cpu"),
                              memory_budget="1MB", num_partitions=2)
    assert {"partitions", "partition_loads", "prefetches",
            "peak_resident_bytes"} <= set(run.stats())
    snap = REGISTRY.snapshot()
    label = ooc._OOC.label
    assert snap[f"{label}.fits"] >= 2
    assert snap[f"{label}.loads"] >= run.partition_loads > 0
    assert snap[f"{label}.requests"] >= snap[f"{label}.loads"]
    assert snap[f"{label}.bytes_peak"] > 0
    assert snap[f"{label}.exchange_bytes"] >= run.exchange_bytes > 0
