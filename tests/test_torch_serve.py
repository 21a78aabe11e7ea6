"""PyTorch port, the multi-tenant serving tier: ``repro_torch.serve``
(admission, ``TenantService``, the load generator) and
``repro_torch.launch.serve`` against the JAX package's ``repro.serve`` and
``repro.launch.serve`` on the same seeded inputs.

Tests that compare outputs run deterministically: requests one at a time,
one client thread, or a burst queued before the batcher starts.  The
mixed-load test (4 client threads) asserts only what holds under every
interleaving: every admitted request resolves, the budget holds, and the
parity tenants' labels equal both packages' solo replays (results do not
depend on how requests batch).  Every service and batcher is closed in
``finally``.  Labels, iteration counts, community counts, spill counts and
admission order are exact.  The port runs with ``device="cpu"``.
"""
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import serve as jserve  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import affected_frontier as jfrontier  # noqa: E402
from repro.core import apply_delta as japply  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.graphgen import evolving_sequence as jevolving  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.serve import loadgen as jloadgen  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import affected_frontier, apply_delta  # noqa: E402
from repro_torch.core.graph import graph_fingerprint  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.graphgen import evolving_sequence  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch.microbatch import MicroBatcher  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.serve import loadgen as tloadgen  # noqa: E402

WAIT = 300   # seconds: every wait below is bounded
JAX_CACHE = CompileCache()


def port_engine(backend="segment", **kw):
    return Engine(EngineConfig(device="cpu", backend=backend, **kw),
                  cache=PlanCache())


def jax_engine(backend="segment", **kw):
    return JEngine(JConfig(backend=backend, **kw), cache=JAX_CACHE)


def traces(sizes, rounds, seed0):
    """Per-tenant (base, deltas) in both packages, from the same seeds."""
    return ([jevolving(n, 4.0, rounds, 3, seed=seed0 + i)
             for i, n in enumerate(sizes)],
            [evolving_sequence(n, 4.0, rounds, 3, seed=seed0 + i)
             for i, n in enumerate(sizes)])


def extend(labels, n):
    if n > len(labels):
        return np.concatenate(
            [labels, np.arange(len(labels), n, dtype=np.int32)])
    return labels


def same(a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and a.lpa_iterations == b.lpa_iterations
            and a.split_iterations == b.split_iterations
            and a.num_communities == b.num_communities)


# --- admission queue: the same operations through both packages -----------

def _admission_script(pkg):
    q = pkg.AdmissionQueue(capacity=16)
    for i in range(3):
        q.offer("a", f"a{i}")
    q.offer("b", "b0")
    q.offer("c", "c0")
    got = [q.take(timeout=1), q.take(timeout=1), q.take(timeout=1),
           q.take(timeout=0.05)]
    q.release("b")
    got.append(q.take(timeout=0.05))
    q.release("a")
    got.append(q.take(timeout=1))
    q.release("a")
    got.append(q.take(timeout=1))
    return got, q.stats()


def test_admission_round_robin_matches_reference():
    got, stats = _admission_script(tserve)
    jgot, jstats = _admission_script(jserve)
    assert got == jgot
    assert stats == jstats
    assert got == [("a", "a0"), ("b", "b0"), ("c", "c0"), None, None,
                   ("a", "a1"), ("a", "a2")]
    assert stats["served_per_tenant"] == {"a": 3, "b": 1, "c": 1}
    assert stats["depth"] == 0 and stats["accepted"] == 5


@pytest.mark.parametrize("pkg", [tserve, jserve], ids=["port", "jax"])
def test_admission_backpressure_rejects_and_recovers(pkg):
    q = pkg.AdmissionQueue(capacity=2, retry_after_s=0.01)
    q.offer("a", 1)
    q.offer("b", 2)
    with pytest.raises(pkg.Rejected) as ei:
        q.offer("c", 3)
    rej = ei.value
    assert rej.depth == 2 and rej.capacity == 2
    assert rej.retry_after_s == pytest.approx(0.01)
    assert q.take(timeout=1) == ("a", 1)
    q.offer("c", 3)
    stats = q.stats()
    assert stats["accepted"] == 3 and stats["rejected"] == 1
    assert stats["peak_depth"] == 2


def test_admission_close_drains_then_stops():
    q = tserve.AdmissionQueue(capacity=4)
    q.offer("a", 1)
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.offer("a", 2)
    assert q.take(timeout=1) == ("a", 1)
    assert q.take(timeout=1) is None
    assert q.drained()
    with pytest.raises(ValueError):
        tserve.AdmissionQueue(capacity=0)


def test_admission_take_unblocks_on_concurrent_offer():
    q = tserve.AdmissionQueue(capacity=4)
    got = []
    t = threading.Thread(target=lambda: got.append(q.take(timeout=30)))
    t.start()
    q.offer("a", "late")
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == [("a", "late")]


def test_admission_registry_names_match_reference():
    """The admission scope's metrics: same names, same values (capped
    per-tenant counters included)."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry

    def run(pkg, reg):
        q = pkg.AdmissionQueue(capacity=3, scope=reg.scope("adm"),
                               served_label_cap=2)
        for t in ("x", "y", "z"):
            q.offer(t, 1)
        with pytest.raises(pkg.Rejected):
            q.offer("w", 1)
        for _ in range(3):
            tenant, _ = q.take(timeout=1)
            q.release(tenant)
        return reg.snapshot()

    snap, jsnap = run(tserve, MetricsRegistry()), run(jserve, JRegistry())
    assert snap == jsnap
    assert snap["adm.served.other"] == 1 and snap["adm.rejected"] == 1


# --- the tenant service against solo fits ---------------------------------

@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_service_register_update_refresh_parity(backend):
    """register is a cold fit, update a warm frontier-seeded re-detection,
    refresh a cold re-fit of the current graph: each equals the port's solo
    fit and the JAX engine's."""
    (jbase, jdeltas), (base, deltas) = [t[0] for t in traces((80,), 2, 3)]
    oracle, joracle = port_engine(backend), jax_engine()
    svc = tserve.TenantService(port_engine(backend), tserve.ServiceConfig(
        max_batch=4, queue_capacity=8))
    try:
        res0 = svc.register("t", base).result(timeout=WAIT)
        assert not res0.warm_started
        assert same(res0, oracle.fit(base)) and same(res0, joracle.fit(jbase))

        graph, jgraph, labels = base, jbase, res0.labels
        for d, jd in zip(deltas, jdeltas):
            res = svc.update("t", d).result(timeout=WAIT)
            graph, jgraph = apply_delta(graph, d), japply(jgraph, jd)
            want = oracle.fit(graph, init_labels=labels,
                              init_active=affected_frontier(d, graph.n))
            jwant = joracle.fit(jgraph, init_labels=labels,
                                init_active=jfrontier(jd, jgraph.n))
            assert res.warm_started
            assert same(res, want) and same(res, jwant)
            labels = res.labels
        assert np.array_equal(svc.labels("t"), labels)
        assert graph_fingerprint(svc.graph("t")) == graph_fingerprint(graph)

        resf = svc.refresh("t").result(timeout=WAIT)
        assert not resf.warm_started
        assert same(resf, oracle.fit(graph)) and same(resf,
                                                      joracle.fit(jgraph))

        with pytest.raises(ValueError, match="already registered"):
            svc.register("t", base)
        with pytest.raises(KeyError):
            svc.update("nobody", deltas[0])
        stats = svc.stats()
        assert stats["completed"] == 4 and stats["failed"] == 0
        assert stats["outstanding"] == 0
    finally:
        svc.close()


def test_service_rejected_register_can_be_retried():
    (_, (base, _)) = [t[0] for t in traces((50,), 1, 9)]
    svc = tserve.TenantService(port_engine(),
                               tserve.ServiceConfig(queue_capacity=2))
    try:
        svc.admission.close()               # force the admission failure
        with pytest.raises(RuntimeError):
            svc.register("t", base)
        assert svc.tenants() == []          # rolled back: a retry is possible
    finally:
        svc.close()


def test_service_failed_update_resolves_its_ticket():
    """A request whose delta cannot apply fails its own ticket; the tenant
    stays served and nothing strands."""
    (_, (base, deltas)) = [t[0] for t in traces((60,), 1, 5)]
    svc = tserve.TenantService(port_engine(),
                               tserve.ServiceConfig(queue_capacity=4))
    try:
        svc.register("t", base).result(timeout=WAIT)
        ticket = svc.update("t", "not a delta")
        assert isinstance(ticket.exception(timeout=WAIT), AttributeError)
        assert svc.update("t", deltas[0]).result(timeout=WAIT).warm_started
        stats = svc.stats()
        assert stats["failed"] == 1 and stats["completed"] == 2
        assert stats["outstanding"] == 0
    finally:
        svc.close()


def _spill_run(pkg, engine, trs):
    """The reference test's spill script, one request at a time."""
    out = {}
    svc = pkg.TenantService(engine, pkg.ServiceConfig(
        warm_budget=1000, max_batch=1, queue_capacity=8))
    try:
        for t, (base, _) in trs.items():
            svc.register(t, base).result(timeout=WAIT)
        s = svc.stats()
        out["after_register"] = (s["spills"], s["warm_cached_tenants"],
                                 s["warm_bytes"]["current"],
                                 s["warm_bytes"]["peak"],
                                 [svc.labels(t) is None for t in trs])
        base0, deltas0 = trs["t0"]
        out["t0"] = svc.update("t0", deltas0[0]).result(timeout=WAIT)
        out["spilled_after"] = [svc.labels(t) is None for t in trs]
        out["t2"] = svc.update("t2", trs["t2"][1][0]).result(timeout=WAIT)
        s = svc.stats()
        out["final"] = (s["spills"], s["uncached"], s["warm_bytes"]["peak"])
    finally:
        svc.close()
    tiny = pkg.TenantService(engine, pkg.ServiceConfig(
        warm_budget=100, queue_capacity=4))
    try:
        tiny.register("t", trs["t0"][0]).result(timeout=WAIT)
        s = tiny.stats()
        out["tiny"] = (s["uncached"], s["warm_cached_tenants"],
                       tiny.labels("t") is None)
    finally:
        tiny.close()
    return out


def test_service_warm_budget_spills_lru_tenants_as_reference():
    """Commits past the shared budget spill the least-recently-served
    tenants: the same victims, spill and uncached counts as the
    reference, the ledger never over budget, a spilled tenant's next
    update cold and equal to the solo cold fit."""
    jtr, ttr = traces((100, 100, 100), 1, 0)
    names = ("t0", "t1", "t2")
    got = _spill_run(tserve, port_engine(), dict(zip(names, ttr)))
    want = _spill_run(jserve, jax_engine(), dict(zip(names, jtr)))
    assert got["after_register"] == want["after_register"]
    assert got["after_register"] == (1, 2, 800, 800, [True, False, False])
    assert got["spilled_after"] == want["spilled_after"] == [False, True,
                                                             False]
    assert got["final"] == want["final"]
    assert got["final"][0] == 2 and got["final"][2] <= 1000
    assert got["tiny"] == want["tiny"] == (1, 0, True)
    assert not got["t0"].warm_started and got["t2"].warm_started
    for k in ("t0", "t2"):
        assert same(got[k], want[k]), k
    post0 = apply_delta(ttr[0][0], ttr[0][1][0])
    assert same(got["t0"], port_engine().fit(post0))


# --- snapshot / restore ---------------------------------------------------

def _serve_then_snapshot(pkg, engine, trs, manager):
    svc = pkg.TenantService(engine, pkg.ServiceConfig(queue_capacity=8))
    try:
        for t, (base, _) in trs.items():
            svc.register(t, base).result(timeout=WAIT)
        for t, (_, deltas) in trs.items():
            svc.update(t, deltas[0]).result(timeout=WAIT)
        saved = svc.snapshot(manager)
        pre = {t: (svc.graph(t), np.array(svc.labels(t))) for t in trs}
    finally:
        svc.close()
    return saved, pre


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_restore_resumes_warm_across_packages(tmp_path, writer):
    """A snapshot written by either package's service restores warm into
    the port's: labels bit-identical, a drifted graph refused by
    fingerprint, and the next update the exact warm continuation."""
    names = ("alpha", "beta", "gamma")
    jtr, ttr = traces((90, 100, 110), 2, 20)
    ttr, jtr = dict(zip(names, ttr)), dict(zip(names, jtr))
    if writer == "port":
        saved, pre = _serve_then_snapshot(tserve, port_engine(), ttr,
                                          CheckpointManager(tmp_path))
    else:
        saved, pre = _serve_then_snapshot(jserve, jax_engine(), jtr,
                                          JManager(tmp_path))
    assert set(saved["tenants"]) == set(names)
    assert all(e["warm"] and e["version"] == 1
               for e in saved["tenants"].values())
    graphs_now = {t: apply_delta(ttr[t][0], ttr[t][1][0]) for t in names}
    for t in names:     # the committed graphs are the same in both
        assert list(graph_fingerprint(graphs_now[t])) \
            == saved["tenants"][t]["fingerprint"]

    drifted = apply_delta(graphs_now["gamma"], ttr["gamma"][1][1])
    graphs = {"alpha": graphs_now["alpha"], "beta": graphs_now["beta"],
              "gamma": drifted, "delta": graphs_now["alpha"]}
    svc = tserve.TenantService(port_engine(),
                               tserve.ServiceConfig(queue_capacity=8))
    try:
        report = svc.restore(CheckpointManager(tmp_path), graphs)
        assert sorted(report["restored"]) == ["alpha", "beta"]
        assert report["mismatched"] == ["gamma"]
        assert report["unknown"] == ["delta"]
        assert svc.stats()["restored"] == 2
        warm_iters = cold_iters = 0
        for t in ("alpha", "beta"):
            labels = pre[t][1]
            assert np.array_equal(svc.labels(t), labels)
            d = ttr[t][1][1]
            res = svc.update(t, d).result(timeout=WAIT)
            post = apply_delta(graphs_now[t], d)
            want = port_engine().fit(
                post, init_labels=extend(labels, post.n),
                init_active=affected_frontier(d, post.n))
            assert res.warm_started and same(res, want)
            warm_iters += res.lpa_iterations
            cold_iters += port_engine().fit(post).lpa_iterations
        assert warm_iters < cold_iters
    finally:
        svc.close()


def test_port_snapshot_restores_warm_in_reference(tmp_path):
    """The reverse direction: the port's snapshot re-seeds the JAX
    service, whose next update equals the port service's."""
    names = ("alpha", "beta")
    jtr, ttr = traces((90, 100), 2, 40)
    ttr, jtr = dict(zip(names, ttr)), dict(zip(names, jtr))
    saved, pre = _serve_then_snapshot(tserve, port_engine(), ttr,
                                      CheckpointManager(tmp_path))
    jgraphs = {t: japply(jtr[t][0], jtr[t][1][0]) for t in names}
    jsvc = jserve.TenantService(jax_engine(),
                                jserve.ServiceConfig(queue_capacity=8))
    try:
        report = jsvc.restore(JManager(tmp_path), jgraphs)
        assert sorted(report["restored"]) == list(names)
        for t in names:
            assert np.array_equal(jsvc.labels(t), pre[t][1])
            jres = jsvc.update(t, jtr[t][1][1]).result(timeout=WAIT)
            post = apply_delta(pre[t][0], ttr[t][1][1])
            want = port_engine().fit(
                post, init_labels=extend(pre[t][1], post.n),
                init_active=affected_frontier(ttr[t][1][1], post.n))
            assert jres.warm_started and same(jres, want)
    finally:
        jsvc.close()


# --- service-owned batcher scope and a deterministic burst -----------------

def test_service_batcher_scope_and_burst_batches():
    """A batcher handed to the service with ``autostart=False`` takes the
    registers as one burst: one batch of 4, each member its solo fit; it
    writes under the caller's scope and survives the service's close."""
    (_, ttr) = traces((60, 70, 80, 90), 0, 11)
    eng = port_engine()
    owner = REGISTRY.scope("owner")
    mb = MicroBatcher(eng, max_batch=8, batch_timeout_ms=50,
                      autostart=False, scope=owner.scope("batcher"))
    svc = tserve.TenantService(eng, tserve.ServiceConfig(queue_capacity=8),
                               batcher=mb)
    try:
        tickets = [svc.register(f"t{i}", g) for i, (g, _) in enumerate(ttr)]
        for _ in range(1000):             # the dispatcher hands all 4 over
            if mb._q.qsize() == 4:
                break
            threading.Event().wait(0.01)
        assert mb._q.qsize() == 4
        mb.start()
        results = [t.result(timeout=WAIT) for t in tickets]
        assert mb.batch_sizes == [4]
        for (g, _), res in zip(ttr, results):
            assert same(res, port_engine().fit(g))
        label = svc._obs.label
    finally:
        svc.close()
        snap = REGISTRY.snapshot()
        mb.close(timeout=WAIT)
    assert not any(k.startswith(label + ".") for k in snap)
    assert snap[f"{owner.label}.batcher.requests"] == 4
    assert snap[f"{owner.label}.batcher.batches"] == 1
    owner.release()
    assert not any(k.startswith(owner.label + ".")
                   for k in REGISTRY.snapshot())


# --- the load generator ----------------------------------------------------

def test_build_traces_match_reference():
    cfg = tloadgen.LoadConfig(tenants=3, rounds=2, size=50, delta_edges=3,
                              seed=5)
    tr = tloadgen.build_traces(cfg)
    jtr = jloadgen.build_traces(jloadgen.LoadConfig(
        tenants=3, rounds=2, size=50, delta_edges=3, seed=5))
    assert list(tr) == list(jtr)
    from repro.core.graph import graph_fingerprint as jfp
    for t in tr:
        assert graph_fingerprint(tr[t][0]) == jfp(jtr[t][0])
        for d, jd in zip(tr[t][1], jtr[t][1]):
            assert np.array_equal(d.touched_vertices(),
                                  jd.touched_vertices())


def _one_client_load(pkg, engine, cfg, warm_budget):
    svc = pkg.TenantService(engine, pkg.ServiceConfig(
        queue_capacity=8, warm_budget=warm_budget, max_batch=4,
        retry_after_s=0.002))
    try:
        traces_ = pkg.loadgen.build_traces(cfg)
        records, summary = pkg.loadgen.run_load(svc, traces_, cfg)
        final = {t: svc.labels(t) for t in svc.tenants()}
        order = list(svc.stats()["admission"]["served_per_tenant"].items())
    finally:
        svc.close()
    return traces_, records, summary, final, order


@pytest.mark.parametrize("warm_budget", [None, 700])
def test_run_load_one_client_matches_reference(warm_budget):
    """One client thread: the same requests in the same admission order
    in both packages, so every tenant's final labels, the spill count and
    the request counts are equal; the parity tenants equal both packages'
    solo replays."""
    kw = dict(tenants=5, rounds=3, size=60, delta_edges=3, refresh_every=2,
              parity_tenants=2, client_threads=1, seed=3)
    cfg, jcfg = tloadgen.LoadConfig(**kw), jloadgen.LoadConfig(**kw)
    tr, recs, summ, final, order = _one_client_load(
        tserve, port_engine(), cfg, warm_budget)
    jtr, jrecs, jsumm, jfinal, jorder = _one_client_load(
        jserve, jax_engine(), jcfg, warm_budget)
    for k in ("requests", "completed", "failed", "admitted", "resolved",
              "stranded", "spills", "give_ups", "errors", "warm_bytes_peak"):
        assert summ[k] == jsumm[k], k
    assert summ["requests"] == 5 * 4 and summ["stranded"] == 0
    assert order == jorder
    assert [(r["tenant"], r["kind"], r.get("lpa_iterations"),
             r.get("warm_started")) for r in recs] \
        == [(r["tenant"], r["kind"], r.get("lpa_iterations"),
             r.get("warm_started")) for r in jrecs]
    assert set(final) == set(jfinal)
    for t in final:
        assert (final[t] is None) == (jfinal[t] is None), t
        if final[t] is not None:
            assert np.array_equal(final[t], jfinal[t]), t
    if warm_budget is not None:
        assert summ["spills"] > 0 and summ["warm_bytes_peak"] <= warm_budget
    parity = list(tr)[:cfg.parity_tenants]
    solo = tloadgen.replay_parity(tr, parity, EngineConfig(
        device="cpu", backend="segment"))
    jsolo = jloadgen.replay_parity(jtr, parity, JConfig(backend="segment"))
    for t in parity:
        assert np.array_equal(solo[t], jsolo[t]), t
        if final[t] is not None:
            assert np.array_equal(final[t], solo[t]), t


def test_mixed_load_k8_four_clients_zero_stranded_and_parity():
    """8 tenants, mixed cold/warm/delta traffic from 4 client threads
    through one engine: every admitted request resolves, the queue and
    the warm budget hold, everyone is served, and the parity tenants'
    final labels equal both packages' solo warm replays."""
    kw = dict(tenants=8, rounds=3, size=96, delta_edges=3, refresh_every=3,
              parity_tenants=4, client_threads=4, seed=7)
    cfg = tloadgen.LoadConfig(**kw)
    tr = tloadgen.build_traces(cfg)
    svc = tserve.TenantService(port_engine(), tserve.ServiceConfig(
        queue_capacity=16, warm_budget="64KB", max_batch=8,
        retry_after_s=0.002))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)     # more thread switches, more interleavings
    try:
        records, summary = tloadgen.run_load(svc, tr, cfg)
        final = {t: (None if svc.labels(t) is None
                     else np.array(svc.labels(t))) for t in svc.tenants()}
        stats = svc.stats()
    finally:
        sys.setswitchinterval(switch)
        svc.close()
    assert summary["requests"] == 8 * (1 + 3)
    assert summary["stranded"] == 0 and summary["outstanding"] == 0
    assert summary["give_ups"] == 0 and summary["errors"] == 0
    assert summary["failed"] == 0
    assert summary["completed"] == summary["requests"]
    assert summary["queue_depth_peak"] <= 16
    assert summary["spills"] == 0
    assert summary["warm_bytes_peak"] <= 64_000
    assert stats["admission"]["held"] == 0
    assert len(stats["admission"]["served_per_tenant"]) == 8
    assert summary["p99_ms"] >= summary["p50_ms"] > 0
    assert summary["edges_per_s"] > 0

    parity = {t: final[t] for t in list(tr)[: cfg.parity_tenants]}
    solo = tloadgen.replay_parity(tr, parity, EngineConfig(
        device="cpu", backend="segment"))
    jtr = jloadgen.build_traces(jloadgen.LoadConfig(**kw))
    jsolo = jloadgen.replay_parity(jtr, parity, JConfig(backend="segment"))
    for t, labels in parity.items():
        assert np.array_equal(labels, solo[t]), t
        assert np.array_equal(labels, jsolo[t]), t


# --- launch/serve drivers --------------------------------------------------

def test_serve_communities_matches_reference():
    kw = dict(num_requests=6, backend="segment", size_classes=(40, 70),
              seed=2, max_batch=4)
    recs, summary = tlaunch.serve_communities(device="cpu", **kw)
    jrecs, jsummary = jlaunch.serve_communities(**kw)
    keys = ("n", "edges", "communities", "backend")
    assert [[r[k] for k in keys] for r in recs] \
        == [[r[k] for k in keys] for r in jrecs]
    assert summary["requests"] == jsummary["requests"] == 6
    assert summary["batch_size_hist"] == jsummary["batch_size_hist"] \
        == {2: 1, 4: 1}
    assert summary["edges_per_s"] > 0


def test_serve_streaming_matches_reference():
    kw = dict(num_streams=3, rounds=2, size=60, backend="segment",
              max_batch=4, seed=4)
    recs, summary = tlaunch.serve_streaming(device="cpu", **kw)
    jrecs, jsummary = jlaunch.serve_streaming(**kw)
    assert recs == jrecs
    assert all(r["warm_started"] for r in recs)
    assert summary["mean_frontier_frac"] == pytest.approx(
        jsummary["mean_frontier_frac"])


def test_serve_tenants_matches_reference(tmp_path):
    kw = dict(num_tenants=4, rounds=2, size=60, backend="segment",
              client_threads=1, quality="full", warm_budget="600B")
    recs, summary = tlaunch.serve_tenants(
        device="cpu", snapshot_dir=str(tmp_path / "port"), **kw)
    jrecs, jsummary = jlaunch.serve_tenants(
        snapshot_dir=str(tmp_path / "jax"), **kw)
    for k in ("requests", "completed", "stranded", "spills", "rejections",
              "warm_bytes_peak", "warm_budget"):
        assert summary[k] == jsummary[k], k
    assert summary["spills"] > 0
    h, jh = summary["health"], jsummary["health"]
    assert h["alert_counts"] == jh["alert_counts"]
    for t, tl in h["tenants"].items():
        last, jlast = tl["last"], jh["tenants"][t]["last"]
        assert last["disconnected_fraction"] == 0.0
        assert last["communities"] == jlast["communities"]
        assert last["modularity"] == pytest.approx(jlast["modularity"],
                                                   rel=1e-5)
    named, step, extra = CheckpointManager(tmp_path / "port").load_named()
    jnamed, jstep, jextra = JManager(tmp_path / "jax").load_named()
    assert step == jstep and set(named) == set(jnamed)
    for k in named:
        assert np.array_equal(named[k], jnamed[k]), k
    for t, e in extra["tenants"].items():
        assert e["fingerprint"] == jextra["tenants"][t]["fingerprint"]


def test_serve_main_tenants_jsonl_and_lm_unported(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    tlaunch.main(["--mode", "tenants", "--device", "cpu", "--tenants", "2",
                  "--rounds", "1", "--backend", "segment",
                  "--metrics-jsonl", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines[-1]["tag"] == "shutdown"
    text = capsys.readouterr().out
    assert "[serve-tenants] 2 tenants x 1 rounds" in text
    assert "0 stranded" in text
    # LM serving is ported for every family (A15.2, A15.3's serving
    # part): the dense decoders, the hybrid and RWKV run, here on the CPU
    tlaunch.main(["--mode", "lm", "--arch", "yi-9b", "--device", "cpu",
                  "--batch", "2", "--max-new", "3"])
    assert "[serve] yi-9b: batch=2" in capsys.readouterr().out
    out = tlaunch.serve("yi-9b", batch=2, prompt_len=4, max_new=2,
                        s_max=8, device="cpu")
    assert out["generated"].shape == (2, 2)
    tlaunch.main(["--mode", "lm", "--arch", "jamba-v0.1-52b",
                  "--device", "cpu", "--batch", "2", "--max-new", "3"])
    assert "[serve] jamba-v0.1-52b: batch=2" in capsys.readouterr().out
    out = tlaunch.serve("rwkv6-7b", batch=2, prompt_len=4, max_new=3,
                        s_max=8, device="cpu")
    assert out["generated"].shape == (2, 3)
    assert (out["generated"] >= 0).all() and (out["generated"] < 512).all()
