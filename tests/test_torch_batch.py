"""PyTorch port, batched detection and the fit's host side: ``GraphBatch``,
``Engine.fit_many`` and ``_compact_host`` against the JAX package.

The port's ``fit_many`` must equal the JAX package's ``fit_many`` and the
port's own solo ``fit`` on each member, exactly (labels, both iteration
counts, community counts): the graphs carry integer weights, so float32
per-community sums are order-free, and the segment path folds real weights
in index order.  The port runs with ``device="cpu"``, where the kernels take
their plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

from conftest import random_graph  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro.core import GraphBatch as JBatch  # noqa: E402
from repro.core.batch import warm_state_rows as j_warm_state_rows  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro.engine.bucketing import (  # noqa: E402
    batch_bucket_for as j_batch_bucket_for,
    batch_index_arrays as j_batch_index_arrays,
)
from repro_torch.core import GraphBatch  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.batch import warm_state_rows  # noqa: E402
from repro_torch.core.lpa import segment_sum  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    PLAN_LOG,
    Engine,
    EngineConfig,
    PlanCache,
    choose_backend_batch,
    get_backend,
)
from repro_torch.engine.bucketing import (  # noqa: E402
    batch_bucket_for,
    batch_index_arrays,
    bucket_for,
)
from repro_torch.engine.engine import _compact_host  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
JAX_CACHE = CompileCache()
SPLITS = ("none", "lp", "lpp", "bfs_host")
PORT_BACKENDS = [("segment", "auto"), ("tile", "off"), ("tile", "on")]


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def graph_mix():
    """The reference's mix: mixed and duplicate sizes, a disconnected random
    graph and an edgeless member."""
    return [
        jgen.erdos_renyi(150, 5.0, seed=1),
        jgen.karate_club()[0],
        random_graph(77, 4.0, seed=3),
        jgen.erdos_renyi(150, 5.0, seed=8),
        jgen.planted_partition(4, 25, 0.3, 0.01, seed=2)[0],
        jbuild(np.zeros((0, 2), np.int64), n=9),
    ]


_JAX_RESULTS: dict = {}


def jax_fit_many(graphs, key, backend, **cfg):
    """The JAX package's fit_many, memoised per case: fusion does not
    change its results, so the port's fused and unfused fits share one."""
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = JEngine(JConfig(**cfg), cache=JAX_CACHE).fit_many(
            graphs, backend=backend)
    return _JAX_RESULTS[key]


def port_engine(backend, fuse, **cfg):
    return Engine(EngineConfig(device="cpu", backend=backend,
                               fuse_sweeps=fuse, **cfg), cache=PlanCache())


def assert_same(want, got, ctx):
    assert np.array_equal(want.labels, got.labels), ctx
    assert want.lpa_iterations == got.lpa_iterations, ctx
    assert want.split_iterations == got.split_iterations, ctx
    assert want.num_communities == got.num_communities, ctx


def check_against_both(jgraphs, want, eng, got, ctx, solo_kw=None):
    """Port fit_many == JAX fit_many and == the port's solo fits."""
    assert len(got) == len(jgraphs)
    for i, g in enumerate(jgraphs):
        assert_same(want[i], got[i], (*ctx, i, "jax"))
        assert got[i].batch_size == want[i].batch_size == len(jgraphs)
        assert got[i].batch_index == want[i].batch_index == i
        solo = eng.fit(port_of(g), **(solo_kw[i] if solo_kw else {}))
        assert_same(solo, got[i], (*ctx, i, "solo"))
        assert got[i].labels.dtype == np.int32


# --- fit_many parity ------------------------------------------------------

@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
def test_fit_many_matches_reference(split, backend, fuse):
    jgraphs = graph_mix()
    want = jax_fit_many(jgraphs, (backend, split), backend, split=split)
    graphs = [port_of(g) for g in jgraphs]
    eng = port_engine(backend, fuse, split=split)
    got = eng.fit_many(graphs)
    check_against_both(jgraphs, want, eng, got, (backend, fuse, split))
    assert {r.backend for r in got} == {backend}
    if split != "none":
        for g, r in zip(graphs, got):
            assert r.check_connected(g) == 0.0


@pytest.mark.parametrize("kw", [{"shortcut": True, "split": "lpp"},
                                {"shortcut": True, "split": "lp"},
                                {"bucketing": "exact"}],
                         ids=["shortcut-lpp", "shortcut-lp", "exact"])
@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
def test_fit_many_shortcut_and_exact_match_reference(kw, backend, fuse):
    jgraphs = graph_mix()[:3]
    want = jax_fit_many(jgraphs, (backend, *sorted(kw.items())), backend,
                        **kw)
    eng = port_engine(backend, fuse, **kw)
    got = eng.fit_many([port_of(g) for g in jgraphs])
    check_against_both(jgraphs, want, eng, got, (backend, fuse, kw))
    if kw.get("bucketing") == "exact":   # (k, n); the reference's m and
        assert got[0].bucket[:2] == want[0].bucket[:2]   # d are lane-padded


@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
def test_fit_many_warm_members_match_reference(backend, fuse):
    """Warm members (init_labels, some with an init_active frontier) mixed
    with cold ones; a frontier without labels is dropped (cold)."""
    jgraphs = graph_mix()[:5]
    cold = JEngine(JConfig(), cache=JAX_CACHE).fit_many(jgraphs,
                                                       backend="segment")
    rng = np.random.default_rng(7)
    labels = [cold[0].labels, None, cold[2].labels, cold[3].labels, None]
    active = [rng.random(jgraphs[0].n) < 0.2, None, None,
              rng.random(jgraphs[3].n) < 0.5,
              rng.random(jgraphs[4].n) < 0.5]
    want = JEngine(JConfig(), cache=JAX_CACHE).fit_many(
        jgraphs, init_labels=labels, init_active=active, backend=backend)
    eng = port_engine(backend, fuse)
    got = eng.fit_many([port_of(g) for g in jgraphs], init_labels=labels,
                       init_active=active)
    solo_kw = [dict(init_labels=lab, init_active=act)
               for lab, act in zip(labels, active)]
    check_against_both(jgraphs, want, eng, got, (backend, fuse), solo_kw)
    assert [r.warm_started for r in got] == [True, False, True, True, False]
    assert [r.warm_started for r in want] == [r.warm_started for r in got]


@pytest.mark.parametrize("backend,fuse", PORT_BACKENDS)
def test_fit_many_awkward_members_match_reference(backend, fuse):
    """An empty, an edgeless and a one-vertex member beside karate club.
    The empty member's iteration counts are the JAX package's batched ones
    (0), not a solo pow2 fit's (1): both packages start a slot of size 0
    converged."""
    jgraphs = [jbuild(np.zeros((0, 2), np.int64), n=7),
               jbuild(np.zeros((0, 2), np.int64), n=0),
               jgen.karate_club()[0],
               jbuild(np.zeros((0, 2), np.int64), n=1)]
    want = jax_fit_many(jgraphs, ("awkward", backend), backend)
    eng = port_engine(backend, fuse)
    got = eng.fit_many([port_of(g) for g in jgraphs])
    for i, g in enumerate(jgraphs):
        assert_same(want[i], got[i], (backend, fuse, i))
        assert np.array_equal(got[i].labels, eng.fit(port_of(g)).labels)
    assert [r.num_communities for r in got] == [7, 0, 5, 1]
    assert (got[1].lpa_iterations, got[1].split_iterations) == (0, 0)


def test_fit_many_real_weights_match_reference():
    """Real weights on the segment path: each run folds in index order in
    both packages, and packing keeps each member's edge order."""
    rng = np.random.default_rng(5)
    jgraphs = []
    for n in (90, 120):
        e = rng.integers(0, n, size=(3 * n, 2))
        w = rng.uniform(0.5, 4.0, size=3 * n).astype(np.float32)
        jgraphs.append(jbuild(e, w, n=n))
    want = jax_fit_many(jgraphs, ("real",), "segment")
    eng = port_engine("segment", "auto")
    got = eng.fit_many([port_of(g) for g in jgraphs])
    check_against_both(jgraphs, want, eng, got, ("real",))


# --- plan cache, results, options -------------------------------------------

def test_same_batch_bucket_builds_plans_once():
    mix1 = [jgen.erdos_renyi(150, 5.0, seed=1), jgen.erdos_renyi(90, 4.0, seed=2)]
    mix2 = [jgen.erdos_renyi(120, 5.0, seed=3), jgen.erdos_renyi(110, 4.0, seed=4)]
    for backend, fuse, stages in (
            ("segment", "auto", {"segment:batch_propagate",
                                 "segment:batch_split"}),
            ("tile", "off", {"tile:batch_propagate", "tile:batch_split"}),
            ("tile", "on", {"tile:batch_propagate_fused",
                            "tile:batch_split_fused"})):
        eng = port_engine(backend, fuse)
        before = PLAN_LOG.snapshot()
        r1 = eng.fit_many([port_of(g) for g in mix1])
        mid = PLAN_LOG.snapshot()
        r2 = eng.fit_many([port_of(g) for g in mix2])
        after = PLAN_LOG.snapshot()
        first = {k: mid[k] - before.get(k, 0) for k in mid
                 if mid[k] != before.get(k, 0)}
        assert first == {s: 1 for s in stages}, (backend, fuse)
        assert after == mid, (backend, fuse)
        assert r1[0].bucket == r2[0].bucket and len(r1[0].bucket) == 4
        assert not r1[0].cache_hit and r2[0].cache_hit


def test_fit_many_trivial_inputs():
    eng = port_engine("auto", "auto")
    assert eng.fit_many([]) == []
    g = port_of(jgen.karate_club()[0])
    (only,) = eng.fit_many([g])
    assert np.array_equal(only.labels, eng.fit(g).labels)
    assert (only.batch_size, only.batch_index) == (1, 0)


def test_fit_many_prorated_timings_and_metrics():
    jgraphs = graph_mix()[:3]
    want = JEngine(JConfig(compute_metrics=True), cache=JAX_CACHE).fit_many(
        jgraphs)
    got = port_engine("segment", "auto", compute_metrics=True).fit_many(
        [port_of(g) for g in jgraphs])
    for w, r in zip(want, got):
        assert set(r.timings) == set(w.timings) == {
            "prorated_prepare", "prorated_propagation", "prorated_split",
            "split", "compact"}
        assert r.disconnected_fraction == 0.0 == w.disconnected_fraction
        assert r.modularity == pytest.approx(w.modularity, rel=1e-5,
                                             abs=1e-6)
        assert r.lpa_seconds == r.timings["prorated_propagation"]
        assert r.device == "cpu"


def test_fit_many_checks_inputs(tmp_path, monkeypatch):
    from repro_torch.core.delta import undirected_edges
    from repro_torch.io import write_mtx
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path / "store"))
    eng = port_engine("segment", "auto")
    graphs = [port_of(g) for g in graph_mix()[:2]]
    with pytest.raises(ValueError, match="entries"):
        eng.fit_many(graphs, init_labels=[None])
    with pytest.raises(ValueError, match="entries"):
        eng.fit_many(graphs, init_active=[None, None, None])
    with pytest.raises(ValueError, match="stale"):
        eng.fit_many(graphs, init_labels=[np.zeros(3, np.int32), None])
    with pytest.raises(ValueError):   # checked even when dropped (cold)
        eng.fit_many(graphs, init_active=[np.ones(3, bool), None])
    # A8 is ported: graph-file paths fit as their graphs do
    path = tmp_path / "karate.mtx"
    write_mtx(path, undirected_edges(graphs[1])[0], n=graphs[1].n)
    for r, w in zip(eng.fit_many([graphs[0], str(path)]),
                    eng.fit_many(graphs)):
        assert np.array_equal(r.labels, w.labels)
        assert r.lpa_iterations == w.lpa_iterations
    with pytest.raises(TypeError):
        eng.fit_many([np.zeros((3, 2))])


def test_fit_many_needs_a_batched_backend():
    """A backend without a batched path (``sharded``) serves ``fit_many``
    with sequential solo fits, as the reference's does: each member
    equals its solo fit and the reference's member, warm ones too."""
    graphs = [jgen.karate_club()[0],
              jgen.planted_partition(4, 20, 0.4, 0.02, seed=1)[0]]
    warm = [None, np.arange(graphs[1].n, dtype=np.int32)[::-1].copy()]
    eng = port_engine("sharded", "auto")
    got = eng.fit_many([port_of(g) for g in graphs], init_labels=warm)
    want = JEngine(JConfig(backend="sharded"),
                   cache=CompileCache()).fit_many(graphs, init_labels=warm)
    for i, (w, m, g) in enumerate(zip(want, got, graphs)):
        assert_same(w, m, i)
        assert_same(eng.fit(port_of(g), init_labels=warm[i]), m, i)
        assert (m.backend, m.batch_size, m.warm_started) \
            == ("sharded", 1, warm[i] is not None)


def test_fit_many_default_device_is_cuda():
    if torch.cuda.is_available():
        assert Engine(EngineConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig()).fit_many([port_of(jgen.karate_club()[0])])


def test_choose_backend_batch():
    cfg = EngineConfig(device="cpu")
    small = [port_of(g) for g in graph_mix()]
    assert choose_backend_batch(small, cfg, torch.device("cpu")) == "segment"
    assert choose_backend_batch(small, cfg, torch.device("cuda")) == "tile"
    # the cell limit applies to the packed totals: 1<<24 cells at D=32
    many = small * 8
    n_total = sum(g.n for g in many)
    wide = tgraph.build_graph(np.stack([np.zeros(600, np.int64),
                                        np.arange(1, 601)], 1))
    assert n_total * 32 < (1 << 24)
    assert choose_backend_batch(many, cfg, torch.device("cuda")) == "tile"
    assert choose_backend_batch(many + [wide], cfg,
                                torch.device("cuda")) == "tile"
    star = tgraph.build_graph(np.stack([np.zeros(1500, np.int64),
                                        np.arange(1, 1501)], 1))
    assert choose_backend_batch(small + [star], cfg,
                                torch.device("cuda")) == "segment"
    assert all(get_backend(b).supports_batch for b in ("segment", "tile"))


# --- GraphBatch --------------------------------------------------------------

def test_pack_matches_reference():
    jgraphs = graph_mix()
    want = JBatch.pack(jgraphs)
    got = GraphBatch.pack([port_of(g) for g in jgraphs])
    assert got.num_graphs == want.num_graphs == len(jgraphs)
    for f in ("sizes", "offsets", "edge_counts", "graph_id"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.vertex_offsets(), want.vertex_offsets())
    m = want.graph.num_edges
    assert got.graph.num_edges == got.graph.m_pad == m == want.total_edges
    for f in ("src", "dst", "wgt"):
        assert np.array_equal(getattr(got.graph, f).numpy(),
                              np.asarray(getattr(want.graph, f))[:m]), f
    assert got.graph.edge_mask.all()
    for f in ("row_ptr", "kdeg"):
        assert np.array_equal(getattr(got.graph, f).numpy(),
                              np.asarray(getattr(want.graph, f))), f


def test_pack_handles_edgeless_and_empty_members():
    def empty(n):
        return tgraph.build_graph(np.zeros((0, 2), np.int64), n=n)
    karate = port_of(jgen.karate_club()[0])
    batch = GraphBatch.pack([empty(7), empty(0), karate, empty(1)])
    assert batch.total_vertices == 7 + 0 + 34 + 1
    assert batch.sizes.tolist() == [7, 0, 34, 1]
    labels = np.concatenate([np.zeros(7, np.int32), np.zeros(0, np.int32),
                             np.arange(34, dtype=np.int32),
                             np.zeros(1, np.int32)])
    out = batch.unpack(labels)
    assert [len(o) for o in out] == [7, 0, 34, 1]
    assert out[0].max() == 0 and out[2].tolist() == list(range(34))
    only_empty = GraphBatch.pack([empty(0), empty(3)])
    assert only_empty.total_edges == 0 and only_empty.graph.n == 3


def test_pack_empty_list_rejected():
    with pytest.raises(ValueError):
        GraphBatch.pack([])
    with pytest.raises(ValueError):
        GraphBatch.pack([port_of(jgen.karate_club()[0])]).unpack(
            np.zeros(3, np.int32))
    batch = GraphBatch.pack([port_of(jgen.karate_club()[0])])
    with pytest.raises(ValueError, match="entries"):
        batch.pack_labels([None, None])
    with pytest.raises(ValueError, match="entries"):
        batch.pack_active([])


member = st.tuples(st.integers(0, 40), st.integers(0, 60),
                   st.integers(0, 10_000))


@settings(derandomize=True, deadline=None, max_examples=15)
@given(st.lists(member, min_size=1, max_size=5))
def test_pack_unpack_roundtrip_matches_reference(specs):
    """Random mixes with empty, edgeless and duplicate-size members: the
    packing and both unpackings equal the reference's, and the warm-state
    packing round-trips."""
    def make(spec):
        n, deg_tenths, seed = spec
        if n == 0 or deg_tenths == 0:
            return jbuild(np.zeros((0, 2), np.int64), n=n)
        return random_graph(n, deg_tenths / 10.0, seed=seed)
    jgraphs = [make(s) for s in specs]
    want = JBatch.pack(jgraphs)
    got = GraphBatch.pack([port_of(g) for g in jgraphs])
    assert np.array_equal(got.graph_id, want.graph_id)
    assert np.array_equal(got.graph.row_ptr.numpy(),
                          np.asarray(want.graph.row_ptr))
    rng = np.random.default_rng(len(specs))
    per = [rng.integers(0, max(g.n, 1), size=g.n).astype(np.int32)
           for g in jgraphs]
    flat = (np.concatenate(per) if got.total_vertices
            else np.zeros(0, np.int32))
    for compact in (True, False):
        for a, b in zip(got.unpack(flat, compact), want.unpack(flat, compact)):
            assert np.array_equal(a, b) and a.dtype == np.int32
    labels = [p if i % 2 else None for i, p in enumerate(per)]
    active = [None if i % 2 else rng.random(len(p)) < 0.5
              for i, p in enumerate(per)]
    for fn in ("pack_labels", "pack_active"):
        arg = labels if fn == "pack_labels" else active
        a, b = getattr(got, fn)(arg), getattr(want, fn)(arg)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("warm", ["cold", "labels", "active", "both"])
def test_warm_state_rows_matches_reference(warm):
    jgraphs = graph_mix()
    batch = GraphBatch.pack([port_of(g) for g in jgraphs])
    rows = 1024
    _, _, voffset = batch_index_arrays(batch, 8, rows)
    rng = np.random.default_rng(2)
    nt = batch.total_vertices
    lab = rng.integers(0, 50, size=nt).astype(np.int32) \
        if warm in ("labels", "both") else None
    act = rng.random(nt) < 0.3 if warm in ("active", "both") else None
    got = warm_state_rows(rows, voffset, lab, act)
    want = j_warm_state_rows(rows, voffset, lab, act)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b)) and a.dtype == b.dtype


@pytest.mark.parametrize("bucketing", ["pow2", "exact"])
def test_batch_index_and_bucket_match_reference(bucketing):
    jgraphs = graph_mix()
    jb = JBatch.pack(jgraphs)
    tb = GraphBatch.pack([port_of(g) for g in jgraphs])
    want_key = j_batch_bucket_for(jb, bucketing=bucketing)
    got_key = batch_bucket_for(tb, bucketing=bucketing)
    # the reference rounds the tile width up to 128 lanes and the exact
    # edge count to 128: TPU layout, which the port drops
    assert got_key.k == want_key.k and got_key.n == want_key.n
    if bucketing == "pow2":
        assert got_key.m == want_key.m
    assert got_key.d == bucket_for(tb.graph, bucketing=bucketing).d
    for k_bucket, rows in ((got_key.k, got_key.n), (8, 2048)):
        for a, b in zip(batch_index_arrays(tb, k_bucket, rows),
                        j_batch_index_arrays(jb, k_bucket, rows)):
            assert np.array_equal(a, b) and a.dtype == b.dtype


def test_segment_sum_counts_integers_exactly():
    rng = np.random.default_rng(4)
    ids = np.sort(rng.integers(0, 9, size=5000)).astype(np.int32)
    vals = rng.random(5000) < 0.4
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 11,
                      sorted_ids=True)
    want = np.bincount(ids, weights=vals, minlength=11).astype(np.int64)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    perm = rng.permutation(5000)
    shuffled = segment_sum(torch.from_numpy(vals[perm].astype(np.int32)),
                           torch.from_numpy(ids[perm]), 11)
    assert np.array_equal(shuffled.numpy(), want)


# --- the fit's host side ------------------------------------------------------

@pytest.mark.parametrize("case", ["gaps", "all_equal", "arange", "single",
                                  "empty"])
def test_compact_host_equals_np_unique(case):
    rng = np.random.default_rng(11)
    labels = {
        "gaps": rng.choice(np.arange(0, 5000, 7), size=3000).astype(np.int32),
        "all_equal": np.full(500, 42, np.int32),
        "arange": np.arange(700, dtype=np.int32),
        "single": np.array([5], np.int32),
        "empty": np.zeros(0, np.int32),
    }[case]
    got, k = _compact_host(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    assert got.dtype == np.int32 and k == len(uniq)
    assert np.array_equal(got, inv.reshape(-1))


def test_compact_host_rejects_negative_labels():
    with pytest.raises(ValueError, match="non-negative"):
        _compact_host(np.array([3, -1, 2], np.int32))


@pytest.mark.parametrize("backend", ["segment", "tile"])
def test_backend_run_returns_only_real_labels(backend):
    """A solo run hands the engine the graph's n labels, not the bucket's
    rows."""
    g = port_of(jgen.erdos_renyi(150, 5.0, seed=1))
    cfg = EngineConfig(device="cpu", backend=backend)
    be = get_backend(backend)
    bucket = bucket_for(g)
    assert bucket.n > g.n
    plan = be.build(bucket, cfg, torch.device("cpu"))
    run = be.run(plan, be.prepare(g, bucket, cfg), g.n, None)
    assert isinstance(run.labels, np.ndarray) and run.labels.shape == (g.n,)
    want = Engine(cfg, cache=PlanCache()).fit(g)
    assert np.array_equal(_compact_host(run.labels)[0], want.labels)
