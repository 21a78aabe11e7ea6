"""PyTorch port, result quality: ``repro_torch.obs.quality`` against the
JAX package's ``repro.obs.quality``.

The same labels give the same report in both packages (integer fields
equal, modularity within 1e-6); ``EngineConfig.quality`` never changes
labels or iteration counts, solo or batched, cold or warm; "basic" pays
no device pass; the report lands in the engine scope's ``quality.*``
metrics.  The port runs with ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.obs import quality as jq  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.obs import REGISTRY, MetricsRegistry, quality as tq  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()
MODES = ("off", "basic", "full")
INT_FIELDS = ("mode", "n", "num_communities", "size_min", "size_max",
              "churn_compared")
FLOAT_FIELDS = ("size_mean", "size_p50", "size_p99", "churn",
                "disconnected_fraction")

GRAPHS = {
    "er": lambda: jgen.erdos_renyi(120, 5.0, seed=7),
    "karate": lambda: jgen.karate_club()[0],
    "figure1": lambda: jgen.figure1_graph()[0],
}


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def port_engine(**cfg):
    return Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache())


def assert_same_report(want, got, ctx):
    for f in INT_FIELDS:
        assert getattr(want, f) == getattr(got, f), (ctx, f)
    for f in FLOAT_FIELDS:
        assert getattr(want, f) == getattr(got, f), (ctx, f)
    if want.modularity is None:
        assert got.modularity is None, ctx
    else:
        assert got.modularity == pytest.approx(want.modularity, abs=1e-6), ctx
    assert set(got.to_dict()) == set(want.to_dict())


# --- the report of given labels -------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["basic", "full"])
def test_compute_quality_matches_reference(name, mode):
    g = GRAPHS[name]()
    rng = np.random.default_rng(5)
    labels = JEngine(JConfig(), cache=JAX_CACHE).fit(g).labels
    prev = rng.integers(0, 4, size=g.n)
    for kw in ({}, {"prev_labels": prev},
               {"disconnected_fraction": 0.25, "num_communities": 99}):
        want = jq.compute_quality(labels, mode=mode, graph=g, **kw)
        got = tq.compute_quality(labels, mode=mode, graph=port_of(g), **kw)
        assert_same_report(want, got, (name, mode, sorted(kw)))
        host_w = jq.compute_quality(labels, mode=mode, **kw)
        host_g = tq.compute_quality(labels, mode=mode, **kw)
        assert host_g.modularity is None
        assert_same_report(host_w, host_g, (name, mode, "host"))


def test_churn_and_canonical_labels_match_reference():
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        a = rng.integers(0, 6, size=n)
        b = rng.integers(0, 6, size=int(rng.integers(0, 45)))
        assert np.array_equal(tq.canonical_labels(a),
                              jq.canonical_labels(a))
        assert tq.label_churn(a, b) == jq.label_churn(a, b)
    assert tq.label_churn(None, np.arange(3)) == (None, 0)
    labels = np.array([0, 0, 1, 1, 2, 2])
    assert tq.label_churn(labels, np.array([5, 5, 9, 9, 0, 0])) == (0.0, 6)
    assert tq.CHURN_BUCKETS == jq.CHURN_BUCKETS
    assert tq.QUALITY_MODES == jq.QUALITY_MODES


@pytest.mark.parametrize("mode", ["off", "verbose"])
def test_compute_quality_rejects_off_and_unknown(mode):
    with pytest.raises(ValueError):
        tq.compute_quality(np.zeros(4, np.int32), mode=mode)


def test_record_report_names_match_reference():
    labels = np.array([0, 0, 1, 2, 2, 2])
    snaps = []
    for mod, reg in ((jq, MetricsRegistry()), (tq, MetricsRegistry())):
        scope = reg.scope("quality")
        mod.record_report(scope, mod.compute_quality(
            labels, mode="full", prev_labels=labels[::-1],
            disconnected_fraction=0.0, modularity=0.5))
        mod.record_report(scope, None)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["quality.reports"] == 1
    assert snaps[1]["quality.disconnected_fraction"] == 0.0


# --- the engine --------------------------------------------------------------

@pytest.mark.parametrize("backend,fuse", [("segment", "auto"),
                                          ("tile", "off"), ("tile", "on")])
def test_engine_quality_matches_reference_and_keeps_parity(backend, fuse):
    for name, make in GRAPHS.items():
        g = make()
        runs = {m: port_engine(quality=m, fuse_sweeps=fuse).fit(
            port_of(g), backend=backend) for m in MODES}
        assert runs["off"].quality is None
        for m in ("basic", "full"):
            ctx = (name, backend, fuse, m)
            r = runs[m]
            assert np.array_equal(r.labels, runs["off"].labels), ctx
            assert (r.lpa_iterations, r.split_iterations) == (
                runs["off"].lpa_iterations, runs["off"].split_iterations)
            want = JEngine(JConfig(quality=m, fuse_sweeps=fuse),
                           cache=JAX_CACHE).fit(g, backend=backend)
            assert_same_report(want.quality, r.quality, ctx)
        assert runs["basic"].quality.modularity is None
        assert runs["basic"].quality.disconnected_fraction is None
        full = runs["full"]
        assert full.quality.disconnected_fraction == 0.0
        assert full.disconnected_fraction == 0.0
        assert full.modularity == full.quality.modularity


def test_engine_quality_batched_and_warm():
    graphs = [jgen.erdos_renyi(n, 5.0, seed=n) for n in (60, 90, 120)]
    ports = [port_of(g) for g in graphs]
    prev = [port_engine().fit(g).labels for g in ports]
    runs = {m: port_engine(quality=m).fit_many(ports, init_labels=prev)
            for m in MODES}
    want = JEngine(JConfig(quality="full"), cache=JAX_CACHE).fit_many(
        graphs, init_labels=prev)
    for i in range(len(graphs)):
        ref = runs["off"][i]
        for m in ("basic", "full"):
            r = runs[m][i]
            assert np.array_equal(ref.labels, r.labels)
            assert ref.lpa_iterations == r.lpa_iterations
            assert r.warm_started and r.quality.churn is not None
            assert r.quality.churn_compared == ports[i].n
        assert_same_report(want[i].quality, runs["full"][i].quality, i)
    cold = port_engine(quality="full").fit(ports[0])
    assert cold.quality.churn is None and cold.quality.churn_compared == 0


def test_engine_quality_writes_the_engine_scope():
    g = port_of(jgen.karate_club()[0])
    eng = port_engine(quality="full")
    label = eng._q_obs.label
    assert label.endswith(".quality") and label.startswith("engine")
    eng.fit(g)
    eng.fit(g, init_labels=np.zeros(g.n, np.int32))
    snap = REGISTRY.snapshot()
    assert snap[f"{label}.reports"] == 2
    assert snap[f"{label}.disconnected_fraction"] == 0.0
    assert f"{label}.modularity" in snap
    assert snap[f"{label}.churn"]["count"] == 1
    assert port_engine()._q_obs is None


def test_quality_config_validation_and_plans():
    for m in MODES:
        assert EngineConfig(device="cpu", quality=m).quality == m
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", quality="loud")
    assert len({EngineConfig(device="cpu", quality=m).algo_key()
                for m in MODES}) == 1
    cache = PlanCache()
    g = port_of(jgen.karate_club()[0])
    for m in MODES:
        Engine(EngineConfig(device="cpu", quality=m), cache=cache).fit(g)
    assert cache.stats()["plans"] == 1


def test_check_connected_is_cached_by_fingerprint(monkeypatch):
    import repro_torch.core.detect as detect
    g1 = port_of(jgen.erdos_renyi(80, 5.0, seed=1))
    g2 = port_of(jgen.erdos_renyi(80, 5.0, seed=2))
    res = port_engine(quality="full").fit(g1)
    fp = res._connected_fp
    assert res.disconnected_fraction == 0.0 and fp is not None
    calls = []
    real = detect.disconnected_fraction

    def counting(graph, labels):
        calls.append(graph)
        return real(graph, labels)

    monkeypatch.setattr(detect, "disconnected_fraction", counting)
    assert res.check_connected(g1) == 0.0 and not calls
    res.check_connected(g2)
    assert len(calls) == 1
    res.check_connected(g2)
    assert len(calls) == 1


def test_detection_result_profile_and_quality_not_compared():
    fields = {f.name: f for f in dataclasses.fields(
        port_engine(quality="basic").fit(port_of(jgen.karate_club()[0])))}
    for name in ("profile", "quality", "_connected_fp"):
        assert fields[name].compare is False
