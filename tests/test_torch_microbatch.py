"""PyTorch port, the micro-batching scheduler: batch formation, results
equal to solo fits (the port's and the JAX package's), error propagation
and shutdown.  Every ``result``, ``join`` and ``close`` carries a timeout,
so no test can hang.  The engines run with ``device="cpu"``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.launch.microbatch import MicroBatcher  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
WAIT = 60   # seconds: every wait below is bounded


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def fresh_engine(**kw):
    return Engine(EngineConfig(device="cpu", **kw), cache=PlanCache())


def er(n, deg, seed):
    return port_of(jgen.erdos_renyi(n, deg, seed=seed))


def closed(mb):
    mb.close(timeout=WAIT)
    assert not mb._thread.is_alive()


def test_batches_form_and_results_match_solo_fits():
    jgraphs = [jgen.erdos_renyi(n, 4.0, seed=i)
               for i, n in enumerate((60, 80, 60, 90, 70))]
    eng = fresh_engine(backend="segment")
    mb = MicroBatcher(eng, max_batch=2, batch_timeout_ms=50, autostart=False)
    subs = [mb.submit(port_of(g)) for g in jgraphs]
    mb.start()
    results = [s.result(timeout=WAIT) for s in subs]
    closed(mb)

    # deterministic drain of a pre-enqueued burst: ceil-chunks of max_batch
    assert mb.batch_sizes == [2, 2, 1]
    assert [s.batch_size for s in subs] == [2, 2, 2, 2, 1]
    assert [r.batch_size for r in results] == [2, 2, 2, 2, 1]
    assert all(s.latency_s is not None and s.latency_s > 0 for s in subs)
    jeng = JEngine(JConfig(backend="segment"), cache=CompileCache())
    ref = fresh_engine(backend="segment")
    for g, r in zip(jgraphs, results):
        want = jeng.fit(g)
        assert np.array_equal(r.labels, want.labels)
        assert r.lpa_iterations == want.lpa_iterations
        assert r.split_iterations == want.split_iterations
        assert np.array_equal(r.labels, ref.fit(port_of(g)).labels)

    stats = mb.stats()
    assert stats["requests"] == 5 and stats["batches"] == 3
    assert stats["batch_size_hist"] == {1: 1, 2: 2}
    assert stats["mean_batch"] == pytest.approx(5 / 3)
    assert stats["p95_ms"] >= stats["p50_ms"] > 0


def test_submit_after_close_raises_and_close_is_idempotent():
    mb = MicroBatcher(fresh_engine(), max_batch=4, autostart=False)
    closed(mb)
    closed(mb)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(er(20, 3.0, 0))
    assert mb.stats() == {"requests": 0, "batches": 0, "batch_size_hist": {},
                          "mean_batch": 0.0, "p50_ms": 0.0, "p95_ms": 0.0,
                          "mean_ms": 0.0}


def test_worker_exception_propagates_to_waiters():
    class Boom:
        def fit_many(self, graphs, backend=None):
            raise RuntimeError("boom")

    mb = MicroBatcher(Boom(), max_batch=2, autostart=False)
    sub = mb.submit(er(20, 3.0, 0))
    mb.start()
    closed(mb)
    with pytest.raises(RuntimeError, match="boom"):
        sub.result(timeout=WAIT)


def test_worker_crash_outside_dispatch_strands_nothing(monkeypatch):
    """A crash in the queue loop itself (outside _dispatch's guarded engine
    call) fails the batch in flight and every queued future, and later
    submits raise."""
    mb = MicroBatcher(fresh_engine(), max_batch=2, batch_timeout_ms=0,
                      autostart=False)
    monkeypatch.setattr(MicroBatcher, "_dispatch",
                        lambda self, batch: (_ for _ in ()).throw(
                            RuntimeError("loop crash")))
    subs = [mb.submit(er(20, 3.0, i)) for i in range(5)]
    mb.start()
    mb._thread.join(timeout=WAIT)
    assert not mb._thread.is_alive()
    for s in subs:   # in-flight batch members and still-queued submissions
        with pytest.raises(RuntimeError, match="loop crash"):
            s.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="worker died"):
        mb.submit(er(20, 3.0, 9))
    closed(mb)   # still clean: idempotent, no hang


def test_done_callback_fires_on_result_and_exception():
    seen, ev = [], threading.Event()
    eng = fresh_engine(backend="segment")
    mb = MicroBatcher(eng, max_batch=2, batch_timeout_ms=5)
    sub = mb.submit(er(30, 3.0, 0))
    sub.add_done_callback(lambda s: (seen.append(s), ev.set()))
    assert ev.wait(timeout=WAIT)
    closed(mb)
    assert seen == [sub] and sub.done() and sub.exception(timeout=0) is None

    class Boom:
        def fit_many(self, graphs, backend=None):
            raise ValueError("nope")

    ev2 = threading.Event()
    got: list = []
    mb = MicroBatcher(Boom(), max_batch=2)
    sub = mb.submit(er(20, 3.0, 1))
    sub.add_done_callback(lambda s: (got.append(s.exception(timeout=0)),
                                     ev2.set()))
    assert ev2.wait(timeout=WAIT)
    closed(mb)
    assert isinstance(got[0], ValueError)


@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_mixed_warm_cold_batch_matches_solo_fits(backend):
    """A batch mixing cold requests, warm ones with labels, and a frontier
    without labels (dropped: a cold fit) equals solo fits member by member,
    the JAX package's included."""
    jgraphs = [jgen.erdos_renyi(n, 4.0, seed=i)
               for i, n in enumerate((70, 85, 60))]
    jeng = JEngine(JConfig(backend=backend), cache=CompileCache())
    warm = jeng.fit(jgraphs[1]).labels
    rng = np.random.default_rng(3)
    front = [rng.random(g.n) < 0.3 for g in jgraphs]
    kwargs = [{}, dict(init_labels=warm, init_active=front[1]),
              dict(init_active=front[2])]
    eng = fresh_engine(backend=backend)
    mb = MicroBatcher(eng, max_batch=4, batch_timeout_ms=50, autostart=False)
    subs = [mb.submit(port_of(g), **kw) for g, kw in zip(jgraphs, kwargs)]
    mb.start()
    results = [s.result(timeout=WAIT) for s in subs]
    closed(mb)
    assert [s.batch_size for s in subs] == [3, 3, 3]
    for i, (g, kw, got) in enumerate(zip(jgraphs, kwargs, results)):
        for want in (jeng.fit(g, **kw), eng.fit(port_of(g), **kw)):
            assert np.array_equal(got.labels, want.labels), i
            assert got.lpa_iterations == want.lpa_iterations, i
    assert [r.warm_started for r in results] == [False, True, False]


def test_context_manager_drains_on_exit():
    eng = fresh_engine(backend="segment")
    with MicroBatcher(eng, max_batch=8, batch_timeout_ms=5) as mb:
        subs = [mb.submit(er(50, 3.0, i)) for i in range(3)]
    assert not mb._thread.is_alive()
    assert all(s.done() for s in subs)
    assert sum(mb.batch_sizes) == 3


def test_submissions_from_many_threads_all_settle():
    """Eight threads submit at once into a batcher of max_batch 3: every
    request is served once, in some batch, with its solo fit's labels."""
    graphs = [er(40 + 5 * i, 3.0, i) for i in range(16)]
    eng = fresh_engine(backend="segment")
    subs = [None] * len(graphs)
    mb = MicroBatcher(eng, max_batch=3, batch_timeout_ms=2)

    def worker(k):
        for i in range(k, len(graphs), 8):
            subs[i] = mb.submit(graphs[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    results = [s.result(timeout=WAIT) for s in subs]
    closed(mb)
    assert sum(mb.batch_sizes) == len(graphs)
    assert max(mb.batch_sizes) <= 3
    ref = fresh_engine(backend="segment")
    for g, r in zip(graphs, results):
        assert np.array_equal(r.labels, ref.fit(g).labels)


def test_max_batch_checked_and_default_engine_needs_a_card():
    with pytest.raises(ValueError):
        MicroBatcher(fresh_engine(), max_batch=0, autostart=False)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MicroBatcher(Engine(), autostart=False)


def _scoped_run(batcher_cls, engine, graphs, registry, scope=None):
    """A deterministic burst through a batcher; returns its scope label,
    the metrics under it before and after ``close``."""
    mb = batcher_cls(engine, max_batch=2, batch_timeout_ms=50,
                     autostart=False, scope=scope)
    try:
        subs = [mb.submit(g) for g in graphs]
        mb.start()
        for s in subs:
            s.result(timeout=WAIT)
        label = mb._obs.label
        before = {k[len(label) + 1:]: v for k, v in registry.snapshot().items()
                  if k.startswith(label + ".")}
    finally:
        # the reference's close() takes no timeout: the burst has settled
        mb.close(**({"timeout": WAIT} if batcher_cls is MicroBatcher else {}))
    assert not mb._thread.is_alive()
    after = {k for k in registry.snapshot() if k.startswith(label + ".")}
    return label, before, after


@pytest.mark.parametrize("owned", [True, False], ids=["standalone", "scoped"])
def test_scope_metrics_match_reference_and_close_releases_owned_only(owned):
    """A standalone batcher claims a ``batcher`` scope and releases it on
    close; a batcher given a scope (the serving tier's ``serve.batcher``)
    writes under it and leaves it to its owner.  The metric names and the
    deterministic values equal the reference batcher's."""
    from repro.launch.microbatch import MicroBatcher as JBatcher
    from repro.obs import REGISTRY as JREGISTRY
    from repro_torch.obs import REGISTRY

    jgraphs = [jgen.erdos_renyi(n, 4.0, seed=i)
               for i, n in enumerate((50, 60, 70))]
    runs = {}
    for name, cls, eng, graphs, reg in (
            ("port", MicroBatcher, fresh_engine(backend="segment"),
             [port_of(g) for g in jgraphs], REGISTRY),
            ("jax", JBatcher, JEngine(JConfig(backend="segment"),
                                      cache=CompileCache()), jgraphs,
             JREGISTRY)):
        owner = None if owned else reg.scope("serve")
        try:
            label, before, after = _scoped_run(
                cls, eng, graphs, reg,
                None if owner is None else owner.scope("batcher"))
        finally:
            if owner is not None:
                owner_label = owner.label
                kept = {k for k in reg.snapshot()
                        if k.startswith(owner_label + ".")}
                owner.release()
                assert not any(k.startswith(owner_label + ".")
                               for k in reg.snapshot())
        runs[name] = (label, before, after, None if owner is None else kept)

    (label, before, after, kept), jrun = runs["port"], runs["jax"]
    assert set(before) == set(jrun[1]) == {
        "requests", "batches", "batch_size", "latency_ms"}
    assert before["requests"] == jrun[1]["requests"] == 3
    assert before["batches"] == jrun[1]["batches"] == 2
    assert before["batch_size"] == jrun[1]["batch_size"]
    assert before["latency_ms"]["count"] == jrun[1]["latency_ms"]["count"]
    if owned:
        assert label.split("#")[0] == jrun[0].split("#")[0] == "batcher"
        assert after == set() and jrun[2] == set()
    else:
        assert label.startswith("serve") and label.endswith(".batcher")
        assert label.split(".")[1:] == jrun[0].split(".")[1:]
        assert len(after) == len(jrun[2]) == 4     # survives close()
        assert after == kept
