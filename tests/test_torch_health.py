"""PyTorch port, the serving tier's health plane: ``repro_torch.serve``'s
``HealthConfig``, ``TenantTimeline``, ``HealthMonitor`` and
``sample_from_result`` against ``repro.serve``'s, and the per-tenant
timelines of a live ``TenantService`` against the reference service's.

The same sample sequences go through both monitors: alert kinds, values,
the stats dict and the registry writes must be equal.  Live services run
one request at a time (each ticket waited on), so every sample is
deterministic; modularity agrees to rtol 1e-5 (float32 sums in another
order), everything else exactly.  The port runs with ``device="cpu"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import serve as jserve  # noqa: E402
from repro.core import GraphDelta as JDelta  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.graphgen import erdos_renyi as jer  # noqa: E402
from repro.obs import REGISTRY as JREGISTRY  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import GraphDelta  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.graphgen import erdos_renyi  # noqa: E402
from repro_torch.obs import REGISTRY, CappedCounterSet  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve.health import sample_from_result  # noqa: E402

WAIT = 120   # seconds: every wait below is bounded
PKGS = {"port": (tserve, MetricsRegistry), "jax": (jserve, JRegistry)}


def sample(pkg, ts=0.0, kind="update", latency_ms=1.0, **kw):
    return pkg.QualitySample(ts=ts, kind=kind, latency_ms=latency_ms, **kw)


def both(fn):
    """``fn(serve_module, registry_class)`` for each package."""
    return {name: fn(*mods) for name, mods in PKGS.items()}


def port_engine(**kw):
    return Engine(EngineConfig(device="cpu", backend="segment", **kw),
                  cache=PlanCache())


def jax_engine(**kw):
    return JEngine(JConfig(backend="segment", **kw), cache=CompileCache())


# --- config & timeline ---

@pytest.mark.parametrize("kw", [dict(timeline_len=0),
                                dict(modularity_drop=0.0),
                                dict(slo_p99_ms=-1.0),
                                dict(latency_window=0)])
def test_health_config_validation(kw):
    assert tserve.HealthConfig() == tserve.HealthConfig()
    for pkg in (tserve, jserve):
        with pytest.raises(ValueError):
            pkg.HealthConfig(**kw)


def test_timeline_ring_and_p99_match_reference():
    def run(pkg, _reg):
        tl = pkg.TenantTimeline(maxlen=4)
        for i in range(10):
            tl.append(sample(pkg, ts=float(i), latency_ms=float(i)))
        d = tl.to_dict()
        tl2 = pkg.TenantTimeline(maxlen=64)
        for ms in (1.0,) * 20 + (100.0,):
            tl2.append(sample(pkg, latency_ms=ms))
        p_spike = tl2.p99_latency(window=32)
        for _ in range(40):
            tl2.append(sample(pkg, latency_ms=2.0))
        return d, tl.total, len(tl.samples), p_spike, tl2.p99_latency(8)

    got = both(run)
    assert got["port"] == got["jax"]
    d, total, kept, p_spike, p_after = got["port"]
    assert total == 10 and kept == 4 and d["last"]["latency_ms"] == 9.0
    assert p_spike == 100.0 and p_after == 2.0


# --- alerts: the same samples through both monitors ---

def _alerts(fired):
    return [(a.kind, a.tenant, a.value, a.threshold, a.message)
            for a in fired]


def test_modularity_drop_alert_matches_reference():
    def run(pkg, _reg):
        mon = pkg.HealthMonitor(pkg.HealthConfig(modularity_drop=0.05))
        return [_alerts(mon.record("t", sample(pkg, modularity=q)))
                for q in (0.60, 0.57, 0.40, 0.39)]

    got = both(run)
    assert got["port"] == got["jax"]
    assert [len(f) for f in got["port"]] == [0, 0, 1, 0]
    kind, _, value, _, _ = got["port"][2][0]
    assert kind == "modularity_drop" and value == pytest.approx(0.17)


def test_disconnected_alert_matches_reference():
    def run(pkg, _reg):
        mon = pkg.HealthMonitor()
        return [_alerts(mon.record("t", sample(
            pkg, disconnected_fraction=f))) for f in (0.0, 0.25)]

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == []
    kind, _, _, threshold, msg = got["port"][1][0]
    assert kind == "disconnected" and threshold == 0.0
    assert "invariant" in msg


def test_slo_burn_is_edge_triggered_as_reference():
    def run(pkg, _reg):
        mon = pkg.HealthMonitor(pkg.HealthConfig(slo_p99_ms=10.0,
                                                 latency_window=4))
        out = []
        for ms in (5.0, 50.0, 60.0, 1.0, 1.0, 1.0, 1.0, 99.0):
            out.append((_alerts(mon.record("t", sample(pkg, latency_ms=ms))),
                        mon.stats()["burning"]))
        return out

    got = both(run)
    assert got["port"] == got["jax"]
    kinds = [[a[0] for a in fired] for fired, _ in got["port"]]
    assert kinds == [[], ["slo_burn"], [], [], [], [], [], ["slo_burn"]]
    assert got["port"][2][1] == ["t"] and got["port"][6][1] == []


def test_monitor_stats_and_registry_writes_match_reference():
    def run(pkg, reg_cls):
        reg = reg_cls()
        mon = pkg.HealthMonitor(
            pkg.HealthConfig(slo_p99_ms=10.0, latency_window=2),
            scope=reg.scope("serve.health"))
        mon.record("a", sample(pkg, modularity=0.5,
                               disconnected_fraction=0.0))
        mon.record("a", sample(pkg, modularity=0.2, latency_ms=99.0))
        mon.record("b", sample(pkg, modularity=0.4))
        st = mon.stats()
        for a in st["alerts"]:
            a.pop("ts")
        return st, reg.snapshot()

    got = both(run)
    assert got["port"] == got["jax"]
    st, snap = got["port"]
    assert set(st["tenants"]) == {"a", "b"}
    assert st["alert_counts"] == {"modularity_drop": 1, "slo_burn": 1}
    assert snap["serve.health.samples"] == 3
    assert snap["serve.health.tenants"] == 2
    assert snap["serve.health.modularity"] == pytest.approx(0.4)
    assert snap["serve.health.disconnected_fraction"] == 0.0


def test_alert_ring_is_bounded_as_reference():
    def run(pkg, _reg):
        mon = pkg.HealthMonitor(pkg.HealthConfig(max_alerts=8))
        for i in range(20):
            mon.record(f"t{i}", sample(pkg, disconnected_fraction=0.5))
        return len(mon.alerts), mon.stats()["alert_counts"]

    got = both(run)
    assert got["port"] == got["jax"] == (8, {"disconnected": 20})


# --- samples from fits ---

@pytest.mark.parametrize("quality", ["full", "basic", "off"])
def test_sample_from_result_matches_reference(quality):
    """The port's ``DetectionResult.quality`` feeds the same sample fields
    as the reference's (modularity to rtol 1e-5)."""
    jg = jer(120, 5.0, seed=0)
    g = erdos_renyi(120, 5.0, seed=0)
    res = port_engine(quality=quality).fit(g)
    jres = jax_engine(quality=quality).fit(jg)
    s = sample_from_result(res, kind="register", latency_ms=3.5)
    js = jserve.health.sample_from_result(jres, kind="register",
                                          latency_ms=3.5)
    assert s.kind == "register" and s.latency_ms == 3.5
    assert s.communities == js.communities
    assert s.disconnected_fraction == js.disconnected_fraction
    assert s.churn == js.churn
    if quality == "off":
        assert s.modularity is None and s.communities is None
    else:
        assert s.communities == res.num_communities
    if quality == "full":
        assert s.disconnected_fraction == 0.0
        assert s.modularity == pytest.approx(js.modularity, rel=1e-5)
        assert s.modularity == pytest.approx(res.quality.modularity)
    else:
        assert s.modularity is None and js.modularity is None


# --- capped per-tenant counters ---

def test_capped_counter_set_overflow_bucket():
    reg = MetricsRegistry()
    s = reg.scope("svc.admission")
    caps = CappedCounterSet(s, "served", max_labels=3)
    for t in ("a", "b", "c", "d", "e", "a"):
        caps.inc(t)
    assert caps.tracked == ("a", "b", "c")
    snap = reg.snapshot()
    assert snap["svc.admission.served.a"] == 2
    assert snap["svc.admission.served.other"] == 2
    assert "svc.admission.served.d" not in snap


def _service_run(pkg, engine, graphs, cfg, deltas=None):
    """Register every graph, then (optionally) one delta each, one request
    at a time; returns the health stats, the registry metrics of the
    service's scope (prefix stripped) and the served counts."""
    reg = REGISTRY if pkg is tserve else JREGISTRY
    svc = pkg.TenantService(engine, cfg)
    try:
        label = svc._obs.label
        for t, g in graphs.items():
            svc.register(t, g).result(timeout=WAIT)
        for t, d in (deltas or {}).items():
            svc.update(t, d).result(timeout=WAIT)
        health = svc.stats()["health"]
        served = svc.stats()["admission"]["served_per_tenant"]
        snap = {k[len(label) + 1:]: v for k, v in reg.snapshot().items()
                if k.startswith(label + ".")}
    finally:
        svc.close()
    assert not any(k.startswith(label + ".") for k in reg.snapshot())
    return health, snap, served


def test_service_served_counters_respect_cap_as_reference():
    sizes = [60 + 10 * i for i in range(5)]
    port = _service_run(
        tserve, port_engine(),
        {f"t{i}": erdos_renyi(n, 5.0, seed=i) for i, n in enumerate(sizes)},
        tserve.ServiceConfig(queue_capacity=16, served_label_cap=2))
    ref = _service_run(
        jserve, jax_engine(),
        {f"t{i}": jer(n, 5.0, seed=i) for i, n in enumerate(sizes)},
        jserve.ServiceConfig(queue_capacity=16, served_label_cap=2))
    _, snap, served = port
    assert snap["admission.served.t0"] == snap["admission.served.t1"] == 1
    assert snap["admission.served.other"] == 3
    assert "admission.served.t2" not in snap
    assert served == {f"t{i}": 1 for i in range(5)} == ref[2]
    served_names = {k for k in snap if k.startswith("admission.served.")}
    assert served_names == {k for k in ref[1]
                            if k.startswith("admission.served.")}
    for k in served_names:
        assert snap[k] == ref[1][k], k


def _strip_ts(health):
    for tl in health["tenants"].values():
        if tl["last"]:
            tl["last"].pop("ts")
            tl["last"].pop("latency_ms")
    for a in health["alerts"]:
        a.pop("ts")
    return health


def test_service_health_timelines_match_reference():
    """quality="full": the same graphs and deltas through both services
    give the same timelines, modularity to rtol 1e-5; the disconnected
    fraction is 0.0 on every served fit; the registry carries the same
    names under the service's scope."""
    rng = np.random.default_rng(7)
    sizes = [90 + 15 * i for i in range(4)]
    ins = [rng.integers(0, n, size=(3, 2)) for n in sizes]
    port = _service_run(
        tserve, port_engine(quality="full"),
        {f"t{i}": erdos_renyi(n, 5.0, seed=10 + i)
         for i, n in enumerate(sizes)},
        tserve.ServiceConfig(queue_capacity=16,
                             health=tserve.HealthConfig()),
        {f"t{i}": GraphDelta.make(insert=e.tolist())
         for i, e in enumerate(ins)})
    ref = _service_run(
        jserve, jax_engine(quality="full"),
        {f"t{i}": jer(n, 5.0, seed=10 + i) for i, n in enumerate(sizes)},
        jserve.ServiceConfig(queue_capacity=16,
                             health=jserve.HealthConfig()),
        {f"t{i}": JDelta.make(insert=e.tolist())
         for i, e in enumerate(ins)})
    health, snap, _ = port
    jhealth, jsnap, _ = ref
    health, jhealth = _strip_ts(health), _strip_ts(jhealth)
    assert set(health["tenants"]) == {f"t{i}" for i in range(4)}
    for t, tl in health["tenants"].items():
        jl = jhealth["tenants"][t]
        assert tl["samples"] == jl["samples"] == 2
        last, jlast = tl["last"], jl["last"]
        assert last["disconnected_fraction"] == 0.0
        assert last["kind"] == jlast["kind"] == "update"
        assert last["communities"] == jlast["communities"]
        assert last["churn"] == pytest.approx(jlast["churn"], rel=1e-5)
        assert last["modularity"] == pytest.approx(jlast["modularity"],
                                                   rel=1e-5)
    assert health["alert_counts"] == jhealth["alert_counts"]
    assert "disconnected" not in health["alert_counts"]
    assert set(snap) == set(jsnap)
    assert snap["health.samples"] == jsnap["health.samples"] == 8
    assert snap["health.tenants"] == 4
    assert snap["health.disconnected_fraction"] == 0.0
    for k in ("completed", "failed", "spills", "admission.accepted",
              "admission.taken", "batcher.requests"):
        assert snap[k] == jsnap[k], k


def test_service_health_latency_only_without_quality():
    g = erdos_renyi(80, 5.0, seed=3)
    svc = tserve.TenantService(port_engine(),
                               tserve.ServiceConfig(queue_capacity=8))
    try:
        svc.register("t", g).result(timeout=WAIT)
        svc.refresh("t").result(timeout=WAIT)
        health = svc.stats()["health"]
    finally:
        svc.close()
    tl = health["tenants"]["t"]
    assert tl["samples"] == 2
    assert tl["last"]["latency_ms"] > 0.0
    assert tl["last"]["modularity"] is None
    assert health["alert_counts"] == {}
