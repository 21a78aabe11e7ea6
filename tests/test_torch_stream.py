"""PyTorch port, warm starts and streaming: the engine's warm cache
(``warm_start="auto"``), warm ``fit_many`` over applied deltas, and
``launch.stream.StreamSession``, against the port's own solo warm fits and
the JAX engine.

For every batch-capable backend and split mode, warm batched re-detection
``fit_many(posts, init_labels=prev, init_active=frontiers)[i]`` must equal
the solo warm ``fit(posts[i], init_labels=prev[i],
init_active=frontiers[i])`` and the JAX engine's solo warm fit: labels and
both iteration counts.  Graphs carry unit weights, so float32 sums are
exact in any order.  The port runs with ``device="cpu"``.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.core import delta as jdelta  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GraphDelta,
    affected_frontier,
    apply_delta,
    apply_delta_patch,
    disconnected_fraction,
)
from repro_torch.core.graph import graph_fingerprint  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    PLAN_LOG,
    Engine,
    EngineConfig,
    PlanCache,
)
from repro_torch.launch import stream as stream_mod  # noqa: E402
from repro_torch.launch.stream import (  # noqa: E402
    StreamSession,
    StreamUpdateError,
)

SPLITS = ("none", "lp", "lpp", "bfs_host")
PORT_BACKENDS = [("segment", "auto"), ("tile", "off"), ("tile", "on")]
JAX_CACHE = CompileCache()


def port_engine(backend="segment", fuse="auto", **cfg):
    return Engine(EngineConfig(device="cpu", backend=backend,
                               fuse_sweeps=fuse, **cfg), cache=PlanCache())


def jax_engine(**cfg):
    return JEngine(JConfig(backend="segment", **cfg), cache=JAX_CACHE)


def traces(sizes=(90, 60, 120), rounds=2, delta_edges=3):
    """Per-stream (base, deltas) in both packages, from the same seeds."""
    return [(jgen.evolving_sequence(n, 4.0, rounds, delta_edges, seed=40 + i),
             tgen.evolving_sequence(n, 4.0, rounds, delta_edges, seed=40 + i))
            for i, n in enumerate(sizes)]


def same(a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and a.lpa_iterations == b.lpa_iterations
            and a.split_iterations == b.split_iterations
            and a.num_communities == b.num_communities)


# --- warm batched parity, against solo warm fits and the JAX engine -------

@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
@pytest.mark.parametrize("split", SPLITS)
def test_fit_many_warm_delta_parity(backend, fuse, split):
    tr = traces()
    eng = port_engine(backend, fuse, split=split)
    jeng = jax_engine(split=split)
    jgraphs = [jb for (jb, _), _ in tr]
    graphs = [tb for _, (tb, _) in tr]
    prev = [eng.fit(g).labels for g in graphs]
    jprev = [jeng.fit(g).labels for g in jgraphs]
    assert all(np.array_equal(a, b) for a, b in zip(prev, jprev))

    for r in range(2):
        jgraphs = [jdelta.apply_delta(g, jds[r])
                   for g, ((_, jds), _) in zip(jgraphs, tr)]
        deltas = [tds[r] for _, (_, tds) in tr]
        graphs = [apply_delta(g, d) for g, d in zip(graphs, deltas)]
        fronts = [affected_frontier(d, g.n) for d, g in zip(deltas, graphs)]
        batched = eng.fit_many(graphs, init_labels=prev, init_active=fronts)
        for i, g in enumerate(graphs):
            ctx = (backend, fuse, split, r, i)
            solo = eng.fit(g, init_labels=prev[i], init_active=fronts[i])
            want = jeng.fit(jgraphs[i], init_labels=prev[i],
                            init_active=fronts[i])
            assert same(batched[i], solo) and same(solo, want), ctx
            assert batched[i].warm_started and solo.warm_started, ctx
            if split != "none":
                assert float(disconnected_fraction(g, torch.from_numpy(
                    batched[i].labels))) == 0.0, ctx
        prev = [res.labels for res in batched]


def test_fit_many_mixed_warm_and_cold_members():
    g1, g2 = tgen.erdos_renyi(80, 4.0, seed=1), tgen.erdos_renyi(95, 4.0,
                                                                 seed=2)
    eng = port_engine()
    warm1 = eng.fit(g1).labels
    batched = eng.fit_many([g1, g2], init_labels=[warm1, None])
    assert batched[0].warm_started and not batched[1].warm_started
    assert same(batched[0], eng.fit(g1, init_labels=warm1))
    assert same(batched[1], eng.fit(g2))


# --- the warm cache --------------------------------------------------------

def test_warm_cache_hits_and_misses_on_structural_change():
    base = tgen.erdos_renyi(70, 4.0, seed=5)
    post = apply_delta(base, GraphDelta.make(insert=[[0, 9], [0, 11]]))
    eng = port_engine(warm_start="auto")
    assert not eng.fit(base).warm_started
    assert eng.fit(base).warm_started          # same structure: hit
    assert not eng.fit(post).warm_started      # the delta: a miss
    assert eng.fit(post).warm_started
    assert eng.fit(base).warm_started          # the old entry lives
    st = eng.stats()
    assert (st["warm_hits"], st["warm_misses"], st["warm_evictions"],
            st["warm_entries"], st["warm_capacity"]) == (3, 2, 0, 2, 64)


def test_auto_warm_equals_explicit_labels_and_the_reference():
    g = tgen.erdos_renyi(150, 5.0, seed=4)
    jg = jgen.erdos_renyi(150, 5.0, seed=4)
    eng = port_engine(warm_start="auto")
    first, second = eng.fit(g), eng.fit(g)
    assert second.warm_started and not first.warm_started
    assert same(second, port_engine().fit(g, init_labels=first.labels))
    jeng = JEngine(JConfig(backend="segment", warm_start="auto"),
                   cache=JAX_CACHE)
    jeng.fit(jg)
    assert same(second, jeng.fit(jg))


def test_warm_cache_applies_to_fit_many_members():
    graphs = [tgen.erdos_renyi(60, 4.0, seed=i) for i in range(3)]
    eng = port_engine(warm_start="auto")
    first = eng.fit_many(graphs)
    assert not any(r.warm_started for r in first)
    second = eng.fit_many(graphs)
    assert all(r.warm_started for r in second)
    oracle = port_engine()
    for g, f, s in zip(graphs, first, second):
        assert same(s, oracle.fit(g, init_labels=f.labels))


def test_fit_many_members_never_warm_off_each_other():
    """The same structure twice in one batch: both members look up the
    cache as it stood before the dispatch, so both start cold."""
    g = tgen.erdos_renyi(60, 4.0, seed=9)
    eng = port_engine(warm_start="auto")
    out = eng.fit_many([g, g])
    assert not any(r.warm_started for r in out)
    assert eng.stats()["warm_entries"] == 1
    assert all(r.warm_started for r in eng.fit_many([g, g]))


def test_stale_labels_shape_mismatch_rejected():
    g = tgen.erdos_renyi(50, 4.0, seed=3)
    grown = apply_delta(g, GraphDelta.make(insert=[[0, 55]]))
    eng = port_engine()
    stale = eng.fit(g).labels
    with pytest.raises(ValueError, match="stale"):
        eng.fit(grown, init_labels=stale)
    with pytest.raises(ValueError, match=r"init_labels\[1\]"):
        eng.fit_many([g, grown], init_labels=[stale, stale])
    with pytest.raises(ValueError):
        eng.fit(g, init_labels=np.full(g.n, g.n + 2))
    with pytest.raises(ValueError):
        eng.fit(g, init_active=np.ones(g.n - 1, dtype=bool))
    with pytest.raises(ValueError):
        eng.fit_many([g, grown], init_labels=[stale])


def test_frontier_without_warm_labels_degrades_to_full_cold_fit():
    g = tgen.erdos_renyi(60, 4.0, seed=21)
    front = np.zeros(g.n, dtype=bool)
    front[:3] = True
    ref = port_engine().fit(g)

    res = port_engine().fit(g, init_active=front)
    assert not res.warm_started and same(res, ref)

    eng = port_engine(warm_start="auto", warm_cache_size=1)
    eng.fit(g)
    eng.fit(tgen.erdos_renyi(70, 4.0, seed=22))   # evicts g's entry
    res = eng.fit(g, init_active=front)           # a miss: full cold fit
    assert not res.warm_started and same(res, ref)
    assert eng.stats()["warm_evictions"] == 2

    batched = port_engine().fit_many([g], init_active=[front])
    assert same(batched[0], ref)


def test_warm_cache_eviction_is_bounded():
    eng = port_engine(warm_start="auto", warm_cache_size=3)
    graphs = [tgen.erdos_renyi(40 + 2 * i, 3.0, seed=i) for i in range(8)]
    for g in graphs:
        eng.fit(g)
        assert eng.stats()["warm_entries"] <= 3
    stats = eng.stats()
    assert stats["warm_capacity"] == 3 and stats["warm_entries"] == 3
    assert stats["warm_evictions"] == 5
    assert eng.fit(graphs[-1]).warm_started        # the newest survives
    assert not eng.fit(graphs[0]).warm_started     # the oldest went


@pytest.mark.parametrize("kw", [dict(warm_cache_size=0),
                                dict(patch_churn_threshold=-0.1),
                                dict(patch_churn_threshold=1.5),
                                dict(warm_start="on")])
def test_warm_options_checked(kw):
    with pytest.raises(ValueError):
        EngineConfig(device="cpu", **kw)


def test_engine_shared_across_threads_is_safe():
    """One engine, many threads: fit, fit_many and stats() race on the
    warm cache under eviction pressure with a short switch interval."""
    from concurrent.futures import ThreadPoolExecutor

    eng = port_engine(warm_start="auto", warm_cache_size=3)
    graphs = [tgen.erdos_renyi(60, 4.0, seed=i) for i in range(6)]
    for g in graphs:
        eng.fit(g)
    fits = [0]
    lock = threading.Lock()

    def worker(k: int) -> None:
        rng = np.random.default_rng(k)
        for _ in range(8):
            op = int(rng.integers(3))
            g = graphs[int(rng.integers(len(graphs)))]
            if op == 0:
                assert len(eng.fit(g).labels) == g.n
                n_fits = 1
            elif op == 1:
                h = graphs[int(rng.integers(len(graphs)))]
                for gr, r in zip((g, h), eng.fit_many([g, h])):
                    assert len(r.labels) == gr.n
                n_fits = 2
            else:
                assert eng.stats()["warm_entries"] <= 3
                n_fits = 0
            with lock:
                fits[0] += n_fits

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=12) as pool:
            for f in [pool.submit(worker, k) for k in range(12)]:
                f.result(timeout=300)
    finally:
        sys.setswitchinterval(old)
    st = eng.stats()
    assert st["warm_entries"] == 3
    # every lookup was counted once: a lost update would break the sum
    assert st["warm_hits"] + st["warm_misses"] == fits[0] + len(graphs)


# --- StreamSession -----------------------------------------------------------

def test_stream_session_update_many_matches_solo_warm_fits():
    tr = traces(sizes=(70, 50), rounds=2)
    oracle = port_engine()
    jeng = jax_engine(split="lp")
    with StreamSession(port_engine(), max_batch=8) as sess:
        added = sess.add_many({i: tb for i, (_, (tb, _)) in enumerate(tr)})
        ref_graphs = [tb for _, (tb, _) in tr]
        jgraphs = [jb for (jb, _), _ in tr]
        ref_labels = [oracle.fit(g).labels for g in ref_graphs]
        for i in range(len(tr)):
            assert np.array_equal(added[i].labels, ref_labels[i])

        for r in range(2):
            results = sess.update_many({i: tds[r]
                                        for i, (_, (_, tds)) in enumerate(tr)})
            for i, ((_, jds), (_, tds)) in enumerate(tr):
                ref_graphs[i] = apply_delta(ref_graphs[i], tds[r])
                jgraphs[i] = jdelta.apply_delta(jgraphs[i], jds[r])
                front = affected_frontier(tds[r], ref_graphs[i].n)
                ref = oracle.fit(ref_graphs[i], init_labels=ref_labels[i],
                                 init_active=front)
                want = jeng.fit(jgraphs[i], init_labels=ref_labels[i],
                                init_active=front)
                ref_labels[i] = ref.labels
                assert results[i].warm_started
                assert same(results[i], ref) and same(ref, want), (r, i)
                assert np.array_equal(sess.labels(i), ref.labels)
                assert graph_fingerprint(sess.graph(i)) \
                    == graph_fingerprint(ref_graphs[i])
                assert sess.graph(i).device.type == "cpu"

        stats = sess.stats()
        assert stats["streams"] == 2 and stats["updates"] == 4
        assert stats["warm_updates"] == 4
        assert 0.0 < stats["mean_frontier_frac"] < 1.0
        assert sess.streams[0].version == 2
        assert sess.streams[0].splice_seconds > 0.0


def test_stream_session_handles_vertex_growth_and_cold_mode():
    base, _ = tgen.evolving_sequence(40, 4.0, 1, 2, seed=9)
    grow = GraphDelta.make(insert=[[0, 45], [45, 46]])
    with StreamSession(port_engine(), max_batch=4) as sess:
        prev = sess.add("g", base).labels
        res = sess.update("g", grow)
        assert sess.graph("g").n == 47 and len(res.labels) == 47
        assert res.warm_started
        # the new vertices start singleton
        post = apply_delta(base, grow)
        init = np.concatenate([prev, np.arange(base.n, 47, dtype=np.int32)])
        assert same(res, port_engine().fit(
            post, init_labels=init,
            init_active=affected_frontier(grow, post.n)))
    with StreamSession(port_engine(), warm=False) as cold:
        cold.add("g", base)
        res = cold.update("g", grow)
        assert not res.warm_started
        assert cold.stats()["warm_updates"] == 0
        assert same(res, port_engine().fit(apply_delta(base, grow)))
    with pytest.raises(ValueError):
        with StreamSession(port_engine()) as sess:
            sess.add("g", base)
            sess.add("g", base)


@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
def test_vertex_growth_builds_one_plan_per_new_bucket(backend, fuse):
    """Growth across the pow2 vertex bucket (256 -> 512) builds each
    batched stage's plan once; a later update in that bucket builds none.
    The grown vertices start singleton, as a solo warm fit from the old
    labels extended by their ids does."""
    base = tgen.erdos_renyi(250, 4.0, seed=3)
    eng = port_engine(backend, fuse)
    oracle = port_engine(backend, fuse)
    with StreamSession(eng, max_batch=2) as sess:
        sess.add("g", base)
        prev = sess.labels("g")
        before = PLAN_LOG.snapshot()
        grow = GraphDelta.make(insert=[[0, 300], [300, 301], [5, 7]])
        res = sess.update("g", grow)
        mid = PLAN_LOG.snapshot()
        built = {k: mid[k] - before.get(k, 0) for k in mid
                 if mid[k] != before.get(k, 0)}
        assert built and set(built.values()) == {1}, built
        assert res.bucket[1] == 512 and not res.cache_hit
        post = apply_delta(base, grow)
        init = np.concatenate([prev, np.arange(len(prev), post.n,
                                               dtype=np.int32)])
        assert same(res, oracle.fit(post, init_labels=init,
                                    init_active=affected_frontier(grow,
                                                                  post.n)))
        mid = PLAN_LOG.snapshot()
        res2 = sess.update("g", GraphDelta.make(insert=[[1, 302]]))
        assert PLAN_LOG.snapshot() == mid and res2.cache_hit


def test_stream_session_churn_threshold_routes_patch_vs_rebuild(monkeypatch):
    calls = []
    monkeypatch.setattr(stream_mod, "apply_delta",
                        lambda g, d: calls.append("rebuild")
                        or apply_delta(g, d))
    monkeypatch.setattr(stream_mod, "apply_delta_patch",
                        lambda g, d: calls.append("patch")
                        or apply_delta_patch(g, d))
    base, _ = tgen.evolving_sequence(60, 4.0, 1, 2, seed=11)
    tiny = GraphDelta.make(insert=[[0, 1], [2, 3]])          # ~7 % churn
    heavy = GraphDelta.make(insert=np.stack(
        [np.arange(0, 30), np.arange(30, 60)], axis=1))      # 100 % churn

    with StreamSession(port_engine(), max_batch=4) as sess:
        sess.add("g", base)
        sess.update("g", tiny)
        assert calls == ["patch"]
        sess.update("g", heavy)
        assert calls == ["patch", "rebuild"]
    calls.clear()
    with StreamSession(port_engine(patch_churn_threshold=0.0),
                       max_batch=4) as sess:
        sess.add("g", base)
        sess.update("g", tiny)
        assert calls == ["rebuild"]


class _FlakyEngine:
    """Fails any dispatch holding a graph of ``poison_n`` vertices while
    armed; passes everything else through."""

    def __init__(self, inner, poison_n: int):
        self._inner = inner
        self.config = inner.config
        self.poison_n = poison_n
        self.armed = True

    def fit_many(self, graphs, backend=None, **kw):
        if self.armed and any(g.n == self.poison_n for g in graphs):
            raise RuntimeError("transient fit failure")
        return self._inner.fit_many(graphs, backend=backend, **kw)


def test_update_many_partial_failure_commits_successes_only():
    (_, (base_a, deltas_a)), (_, (base_b, deltas_b)) = traces(
        sizes=(60, 80), rounds=1)
    flaky = _FlakyEngine(port_engine(), poison_n=base_b.n)
    oracle = port_engine()

    with StreamSession(flaky, max_batch=1) as sess:
        flaky.armed = False
        sess.add_many({"a": base_a, "b": base_b})
        flaky.armed = True
        with pytest.raises(StreamUpdateError) as ei:
            sess.update_many({"a": deltas_a[0], "b": deltas_b[0]})
        err = ei.value
        assert set(err.errors) == {"b"} and set(err.results) == {"a"}
        assert isinstance(err.errors["b"], RuntimeError)
        assert "1 of 2" in str(err) and "1 committed" in str(err)

        post_a = apply_delta(base_a, deltas_a[0])
        ref_a = oracle.fit(post_a, init_labels=oracle.fit(base_a).labels,
                           init_active=affected_frontier(deltas_a[0],
                                                         post_a.n))
        assert same(err.results["a"], ref_a)
        assert np.array_equal(sess.labels("a"), ref_a.labels)
        assert sess.streams["a"].version == 1

        assert graph_fingerprint(sess.graph("b")) \
            == graph_fingerprint(base_b)
        assert sess.streams["b"].version == 0
        stats = sess.stats()
        assert stats["updates"] == 1 and stats["warm_updates"] == 1

        flaky.armed = False
        res_b = sess.update("b", deltas_b[0])
        post_b = apply_delta(base_b, deltas_b[0])
        ref_b = oracle.fit(post_b, init_labels=oracle.fit(base_b).labels,
                           init_active=affected_frontier(deltas_b[0],
                                                         post_b.n))
        assert same(res_b, ref_b)
        assert sess.streams["b"].version == 1
        assert sess.stats()["updates"] == 2
