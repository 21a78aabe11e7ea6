"""PyTorch port, engine layer: ``Engine.fit`` against the JAX engine's
``Engine.fit`` for the tile and segment backends, every split mode,
shortcut, fusion on and off, pow2 and exact bucketing; the plan cache;
and the errors of the device policy and of unported options.

Graphs carry integer weights, so float32 per-community sums are exact in
any order and labels, iteration counts and community counts must be equal.
The port runs with ``device="cpu"``, where its kernels take their plain
versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    PLAN_LOG,
    Engine,
    EngineConfig,
    PlanCache,
    backend_names,
    choose_backend,
)
from repro_torch.engine.bucketing import bucket_for  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()   # one compile per config across the graphs


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


GRAPHS = {
    "er": lambda: jgen.erdos_renyi(180, 5.0, seed=11),
    "planted": lambda: jgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
    "karate": lambda: jgen.karate_club()[0],
    "figure1": lambda: jgen.figure1_graph()[0],
}


def fit_both(g, backend, **cfg):
    want = JEngine(JConfig(**cfg), cache=JAX_CACHE).fit(g, backend=backend)
    got = Engine(EngineConfig(device="cpu", **cfg),
                 cache=PlanCache()).fit(port_of(g), backend=backend)
    return want, got


def assert_same_result(want, got, ctx):
    assert np.array_equal(want.labels, got.labels), ctx
    assert want.lpa_iterations == got.lpa_iterations, ctx
    assert want.split_iterations == got.split_iterations, ctx
    assert want.num_communities == got.num_communities, ctx
    assert got.labels.dtype == np.int32 and got.backend in ctx


@pytest.mark.parametrize("split", ["none", "lp", "lpp", "bfs_host"])
@pytest.mark.parametrize("backend,fuse", [("segment", "auto"),
                                          ("tile", "off"), ("tile", "on")])
def test_fit_matches_reference(split, backend, fuse):
    for name, make in GRAPHS.items():
        g = make()
        want, got = fit_both(g, backend, split=split, fuse_sweeps=fuse)
        assert_same_result(want, got, (name, split, backend, fuse))
        if split != "none":
            assert got.check_connected(port_of(g)) == 0.0


@pytest.mark.parametrize("split", ["lp", "lpp"])
@pytest.mark.parametrize("backend,fuse", [("segment", "auto"),
                                          ("tile", "off"), ("tile", "on")])
def test_shortcut_matches_reference(split, backend, fuse):
    for name, make in GRAPHS.items():
        want, got = fit_both(make(), backend, split=split, shortcut=True,
                             fuse_sweeps=fuse)
        assert_same_result(want, got, (name, split, backend, fuse))


@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_exact_bucketing_matches_reference(backend):
    for name, make in GRAPHS.items():
        want, got = fit_both(make(), backend, bucketing="exact")
        assert_same_result(want, got, (name, backend))
        assert got.bucket[:2] == want.bucket[:2]


def test_warm_start_matches_reference():
    g = jgen.erdos_renyi(150, 4.0, seed=9)
    cold_j, _ = fit_both(g, "segment")
    rng = np.random.default_rng(3)
    frontier = rng.random(g.n) < 0.2
    for backend in ("segment", "tile"):
        want = JEngine(JConfig(), cache=JAX_CACHE).fit(
            g, init_labels=cold_j.labels, init_active=frontier,
            backend=backend)
        got = Engine(EngineConfig(device="cpu"), cache=PlanCache()).fit(
            port_of(g), init_labels=cold_j.labels, init_active=frontier,
            backend=backend)
        assert_same_result(want, got, (backend,))
        assert got.warm_started


def test_compute_metrics_match_reference():
    for name, make in GRAPHS.items():
        g = make()
        want, got = fit_both(g, "tile", compute_metrics=True)
        assert got.disconnected_fraction == 0.0 == want.disconnected_fraction
        # float32 segment sums in another order: a few ulps
        assert got.modularity == pytest.approx(want.modularity, rel=1e-5,
                                               abs=1e-6), name


def test_real_weighted_fit():
    """Real weights: the two packages add a vertex's per-label weights in
    another order, so sums may differ in the last ulp and could flip an
    exact tie.  This graph has no tie that close: labels and iterations
    agree, modularity to rtol 1e-5, and the port's fused and unfused tile
    fits agree bit for bit (one shared argmax)."""
    rng = np.random.default_rng(21)
    e = rng.integers(0, 160, size=(400, 2))
    w = rng.uniform(0.5, 4.0, size=400).astype(np.float32)
    g = jbuild(e, w, n=160)
    want, got = fit_both(g, "segment", compute_metrics=True)
    assert_same_result(want, got, ("segment",))
    assert got.modularity == pytest.approx(want.modularity, rel=1e-5)
    tile = [Engine(EngineConfig(device="cpu", fuse_sweeps=f),
                   cache=PlanCache()).fit(port_of(g), backend="tile")
            for f in ("on", "off")]
    assert np.array_equal(tile[0].labels, tile[1].labels)
    assert tile[0].lpa_iterations == tile[1].lpa_iterations


def test_same_bucket_builds_plans_once():
    """Two different graphs in one bucket: each backend stage builds its
    plan once, and the second fit is a cache hit with a valid result."""
    g1 = port_of(jgen.erdos_renyi(200, 5.0, seed=1))
    g2 = port_of(jgen.erdos_renyi(230, 5.0, seed=2))
    for backend, fuse, stages in (
            ("segment", "auto", {"segment:propagate", "segment:split"}),
            ("tile", "off", {"tile:propagate", "tile:split"}),
            ("tile", "on", {"tile:propagate_fused", "tile:split_fused"})):
        eng = Engine(EngineConfig(backend=backend, fuse_sweeps=fuse,
                                  device="cpu"), cache=PlanCache())
        before = PLAN_LOG.snapshot()
        r1, r2 = eng.fit(g1), eng.fit(g2)
        after = PLAN_LOG.snapshot()
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        assert delta == {s: 1 for s in stages}, (backend, fuse)
        assert r1.bucket == r2.bucket
        assert not r1.cache_hit and r2.cache_hit
        assert r2.check_connected(g2) == 0.0
        assert eng.stats()["hits"] == 1 and eng.stats()["plans"] == 1


def test_second_fit_identical():
    g = port_of(jgen.erdos_renyi(150, 4.0, seed=9))
    eng = Engine(EngineConfig(device="cpu"), cache=PlanCache())
    r1, r2 = eng.fit(g), eng.fit(g)
    assert r2.cache_hit and np.array_equal(r1.labels, r2.labels)
    assert r1.device == "cpu" and set(r1.timings) == {
        "prepare", "propagation", "split", "compact"}


def test_bucket_drops_lane_padding():
    g = port_of(jgen.karate_club()[0])
    assert bucket_for(g) == (256, 2048, 32)          # max degree 17
    assert bucket_for(g, bucketing="exact") == (34, g.m_pad, 17)


def test_choose_backend():
    cfg = EngineConfig(device="cpu")
    g = port_of(jgen.karate_club()[0])
    assert choose_backend(g, cfg, torch.device("cpu")) == "segment"
    assert choose_backend(g, cfg, torch.device("cuda")) == "tile"
    star = tgraph.build_graph(np.stack([np.zeros(1500, np.int64),
                                        np.arange(1, 1501)], 1))
    assert choose_backend(star, cfg, torch.device("cuda")) == "segment"
    # the reference's three, sharded included (A12)
    assert backend_names() == ("segment", "sharded", "tile")


def test_auto_runs_segment_on_cpu():
    g = jgen.karate_club()[0]
    res = Engine(EngineConfig(device="cpu")).fit(port_of(g))
    assert res.backend == "segment"


# --- device policy and unported options ---------------------------------

def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert Engine(EngineConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig())
    with pytest.raises(RuntimeError):
        Engine()


@pytest.mark.parametrize("kw,item", [
    (dict(backend="sharded"), "A12"), (dict(mesh=object()), "A12"),
    (dict(exchange_every=2), "A12"), (dict(memory_budget=1 << 20), "A9"),
    (dict(memory_budget="64MB"), "A9"), (dict(profile="everything"), "A10"),
    (dict(quality="x"), "A10")])
def test_unported_options_raise(kw, item):
    if item == "A9":
        # ported: a budget parses to bytes, as the reference's does
        (option, value), = kw.items()
        got = EngineConfig(device="cpu", **kw).memory_budget
        assert got == JConfig(**kw).memory_budget == int(
            value if isinstance(value, int) else 64_000_000)
        with pytest.raises(ValueError, match=option):
            EngineConfig(device="cpu", memory_budget=0)
        return
    if item == "A12":
        # ported: the sharded options construct, as the reference's do
        (option, value), = kw.items()
        assert getattr(EngineConfig(device="cpu", **kw), option) \
            is getattr(JConfig(**kw), option) is value
        return
    if item == "A10":
        # ported: every mode the reference takes is valid, others raise
        (option, bad), = kw.items()
        with pytest.raises(ValueError, match=option):
            EngineConfig(device="cpu", **kw)
        for mode in ("off", "convergence", "full") if option == "profile" \
                else ("off", "basic", "full"):
            assert getattr(EngineConfig(device="cpu", **{option: mode}),
                           option) == mode
        return
    with pytest.raises(NotImplementedError, match=item):
        EngineConfig(device="cpu", **kw)


def test_unported_calls_raise(tmp_path, monkeypatch):
    from repro_torch.core.delta import undirected_edges
    from repro_torch.io import write_mtx
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path / "store"))
    eng = Engine(EngineConfig(device="cpu"), cache=PlanCache())
    g = port_of(jgen.karate_club()[0])
    # A9 is ported: a budget the edges fit runs in core, a smaller one
    # partitions, both with the same labels
    big, small = (eng.fit(g, memory_budget=b) for b in ("64MB", "3KB"))
    assert big.partitions == 1 and small.partitions > 1
    assert np.array_equal(big.labels, small.labels)
    # A12 is ported: with no process group the sharded backend runs one
    # rank and equals the in-core fit
    sharded = eng.fit(g, backend="sharded")
    assert sharded.backend == "sharded"
    assert np.array_equal(sharded.labels, big.labels)
    assert (sharded.lpa_iterations, sharded.split_iterations) \
        == (big.lpa_iterations, big.split_iterations)
    # A8 is ported: a graph-file path fits as its graph does
    path = tmp_path / "karate.mtx"
    write_mtx(path, undirected_edges(g)[0], n=g.n, symmetric=True)
    assert np.array_equal(eng.fit(str(path), memory_budget="3KB").labels,
                          big.labels)
    res, want = eng.fit(str(path)), eng.fit(g)
    assert np.array_equal(res.labels, want.labels)
    assert (res.lpa_iterations, res.split_iterations) \
        == (want.lpa_iterations, want.split_iterations)


@pytest.mark.parametrize("kw", [dict(kernel_mode="ref"),
                                dict(kernel_mode="pallas"),
                                dict(backend="dense"), dict(split="bfs"),
                                dict(bucketing="pow3"),
                                dict(fuse_sweeps="maybe")])
def test_bad_options_raise(kw):
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", **kw)


def test_warm_start_inputs_are_checked():
    eng = Engine(EngineConfig(device="cpu"), cache=PlanCache())
    g = port_of(jgen.karate_club()[0])
    with pytest.raises(ValueError, match="stale"):
        eng.fit(g, init_labels=np.zeros(g.n + 1, np.int32))
    with pytest.raises(ValueError, match="vertex-id"):
        eng.fit(g, init_labels=np.full(g.n, g.n, np.int32))
    with pytest.raises(ValueError):
        eng.fit(g, init_labels=np.arange(g.n), init_active=np.ones(3, bool))
    with pytest.raises(ValueError):   # checked even when dropped (cold)
        eng.fit(g, init_active=np.ones(3, bool))
    cold = eng.fit(g, init_active=np.zeros(g.n, bool))
    assert not cold.warm_started
    assert np.array_equal(cold.labels, eng.fit(g).labels)
    with pytest.raises(TypeError):
        eng.fit(np.zeros((3, 2)))
