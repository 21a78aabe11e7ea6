"""PyTorch port, core layer: segment propagation, Split-Last, compaction,
the disconnected-community check and modularity against the JAX package's
``repro.core`` on the same graphs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro.core import lpa as jlpa  # noqa: E402
from repro.core import split as jsplit  # noqa: E402
from repro.core.detect import disconnected_communities_host  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import lpa as tlpa  # noqa: E402
from repro_torch.core import split as tsplit  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def random_graph(n, avg_deg, seed, weights=None):
    rng = np.random.default_rng(seed)
    m = max(int(n * avg_deg / 2), 1)
    e = rng.integers(0, n, size=(m, 2))
    w = None
    if weights == "int":
        w = rng.integers(1, 6, size=m).astype(np.float32)
    elif weights == "real":
        w = rng.uniform(0.5, 4.0, size=m).astype(np.float32)
    return jcore.graph.build_graph(e, w, n=n)


GRAPHS = {
    "er": lambda: jgen.erdos_renyi(180, 5.0, seed=11),
    "planted": lambda: jgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
    "karate": lambda: jgen.karate_club()[0],
    "figure1": lambda: jgen.figure1_graph()[0],
    "int_weights": lambda: random_graph(120, 4.0, seed=5, weights="int"),
    "sparse": lambda: random_graph(150, 1.5, seed=8),
}


def same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("it", [0, 5, -1])
def test_lpa_move_matches_reference(name, it):
    jg = GRAPHS[name]()
    tg = port_of(jg)
    rng = np.random.default_rng(it + 100)
    labels = rng.integers(0, jg.n, size=jg.n).astype(np.int32)
    active = rng.random(jg.n) < 0.7
    jn, jc, jd = jlpa.lpa_move(jg, jnp.asarray(labels), jnp.asarray(active),
                               it)
    tn, tc, td = tlpa.lpa_move(tg, torch.from_numpy(labels),
                               torch.from_numpy(active), it)
    assert same(jn, tn) and same(jc, tc) and int(jd) == int(td)
    mask = rng.random(jg.n) < 0.2
    assert same(jlpa.neighbors_of(jg, jnp.asarray(mask)),
                tlpa.neighbors_of(tg, torch.from_numpy(mask)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lpa_run_matches_reference(name):
    jg = GRAPHS[name]()
    tg = port_of(jg)
    js = jlpa.lpa_run(jg, tau=0.05, max_iterations=20)
    ts = tlpa.lpa_run(tg, tau=0.05, max_iterations=20)
    assert same(js.labels, ts.labels) and same(js.active, ts.active)
    assert int(js.iteration) == ts.iteration
    assert int(js.delta_n) == ts.delta_n


def test_lpa_run_bucketed_threshold_and_warm_state():
    """n_real (float32 threshold), warm labels and a sleeping frontier."""
    jg = jgen.erdos_renyi(200, 4.0, seed=2)
    tg = port_of(jg)
    rng = np.random.default_rng(0)
    init = rng.integers(0, 200, size=200).astype(np.int32)
    act = rng.random(200) < 0.3
    for kw_j, kw_t in (
            (dict(n_real=jnp.int32(150)), dict(n_real=150)),
            (dict(init_labels=jnp.asarray(init),
                  init_active=jnp.asarray(act)),
             dict(init_labels=torch.from_numpy(init),
                  init_active=torch.from_numpy(act)))):
        js = jlpa.lpa_run(jg, tau=0.1, max_iterations=7, **kw_j)
        ts = tlpa.lpa_run(tg, tau=0.1, max_iterations=7, **kw_t)
        assert same(js.labels, ts.labels)
        assert int(js.iteration) == ts.iteration


def test_threshold_float32_vs_python():
    assert tlpa.threshold_for(0.05, 1000, None) == int(0.05 * 1000)
    assert tlpa.threshold_for(0.05, 4096, 3000) == int(
        np.float32(0.05) * np.float32(3000))
    # a case where float32 and float64 products truncate differently
    assert tlpa.threshold_for(0.07, 100, 100) == int(
        np.float32(0.07) * np.float32(100))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("prune,shortcut", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_split_matches_reference(name, prune, shortcut):
    jg = GRAPHS[name]()
    tg = port_of(jg)
    comm = np.array(jlpa.lpa_run(jg).labels)
    js = jsplit.split_lp(jg, jnp.asarray(comm), prune=prune,
                         shortcut=shortcut)
    ts = tsplit.split_lp(tg, torch.from_numpy(comm), prune=prune,
                         shortcut=shortcut)
    assert same(js.labels, ts.labels)
    assert int(js.iterations) == ts.iterations
    host = jsplit.split_bfs_host(jg, comm)
    assert np.array_equal(host, tsplit.split_bfs_host(tg, comm))
    assert np.array_equal(host, tsplit.split_bfs_host(
        tg, torch.from_numpy(comm)))


def test_split_lpp_alias():
    jg = GRAPHS["planted"]()
    comm = np.array(jlpa.lpa_run(jg).labels)
    ts = tsplit.split_lpp(port_of(jg), torch.from_numpy(comm))
    js = jsplit.split_lpp(jg, jnp.asarray(comm))
    assert same(js.labels, ts.labels)


def test_compaction_matches_reference():
    rng = np.random.default_rng(4)
    labels = rng.choice([3, 99, 7, 1000, 5], size=300).astype(np.int32)
    assert same(jsplit.compact_labels(jnp.asarray(labels)),
                tsplit.compact_labels(torch.from_numpy(labels)))
    assert int(jsplit.num_communities(jnp.asarray(labels))) == \
        tsplit.num_communities(torch.from_numpy(labels))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_disconnected_check_matches_reference_and_oracle(name):
    jg = GRAPHS[name]()
    tg = port_of(jg)
    rng = np.random.default_rng(1)
    comm = rng.integers(0, 6, size=jg.n).astype(np.int32)   # scattered
    jf, jb, jt = jcore.detect.disconnected_communities(jg, jnp.asarray(comm))
    tf, tb, tt = tcore.disconnected_communities(tg, torch.from_numpy(comm))
    assert same(jf, tf) and int(jb) == int(tb) and int(jt) == int(tt)
    assert float(jcore.disconnected_fraction(jg, jnp.asarray(comm))) == \
        float(tcore.disconnected_fraction(tg, torch.from_numpy(comm)))
    oracle = tcore.disconnected_communities_host(tg, comm)
    assert oracle == disconnected_communities_host(jg, comm)
    for c, bad in oracle.items():
        assert bool(tf[c]) == bad


def test_figure1_split_repairs_the_defection():
    """The paper's Figure 1: after vertex 3 defects, C1 is internally
    disconnected; every split technique separates its two lobes."""
    tg, before, after = tgen.figure1_graph()
    after_t = torch.from_numpy(after)
    assert float(tcore.disconnected_fraction(tg, torch.from_numpy(before))) \
        == 0.0
    assert float(tcore.disconnected_fraction(tg, after_t)) == 0.5
    assert tcore.disconnected_communities_host(tg, after) == {1: True,
                                                              2: False}
    for split in (tsplit.split_lp(tg, after_t).labels,
                  tsplit.split_lpp(tg, after_t).labels,
                  torch.from_numpy(tsplit.split_bfs_host(tg, after))):
        assert float(tcore.disconnected_fraction(tg, split)) == 0.0
        lab = split.numpy()
        assert lab[0] == lab[1] == lab[2] != lab[4] == lab[5] == lab[6]


@pytest.mark.parametrize("name", ["er", "karate", "int_weights", "figure1"])
def test_modularity_matches_reference(name):
    jg = GRAPHS[name]()
    comm = np.array(jlpa.lpa_run(jg).labels)
    want = float(jcore.modularity(jg, jnp.asarray(comm)))
    got = float(tcore.modularity(port_of(jg), torch.from_numpy(comm)))
    # float32 segment sums in another order: a few ulps of the total
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("n,n_comm,seed", [(2, 3, 0), (12, 40, 1),
                                           (30, 5, 2)])
def test_modularity_any_label_values(n, n_comm, seed):
    """Relabeling communities, to ids beyond n too, leaves Q unchanged.
    The JAX package's modularity drops ids >= n (its segment sums have n
    slots), which is why tests/test_modularity.py fails on n=2, n_comm=3;
    the port ranks labels first and agrees with it on ids < n."""
    jg = random_graph(n, 4.0, seed=seed, weights="real")
    tg = port_of(jg)
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, size=n).astype(np.int32)
    perm = rng.permutation(n_comm).astype(np.int32) * 7 + 3
    q = float(tcore.modularity(tg, torch.from_numpy(comm)))
    assert -0.5 - 1e-6 <= q <= 1.0 + 1e-6
    assert float(tcore.modularity(tg, torch.from_numpy(perm[comm]))) == \
        pytest.approx(q, abs=1e-5)
    ranked = np.unique(comm, return_inverse=True)[1].astype(np.int32)
    assert q == pytest.approx(
        float(jcore.modularity(jg, jnp.asarray(ranked))), abs=1e-5)


def test_real_weighted_propagation():
    """Real weights: per-(vertex, label) sums may differ in the last ulp
    when the two packages add a run's weights in another order, which can
    flip an exact tie; on this graph no tie is that close, so labels and
    iterations agree, and the modularity agrees to 1e-5."""
    jg = random_graph(160, 5.0, seed=21, weights="real")
    tg = port_of(jg)
    js = jlpa.lpa_run(jg)
    ts = tlpa.lpa_run(tg)
    assert same(js.labels, ts.labels) and int(js.iteration) == ts.iteration
    assert float(tcore.modularity(tg, ts.labels)) == pytest.approx(
        float(jcore.modularity(jg, js.labels)), rel=1e-5)


def real_planted(seed):
    """A seeded planted partition with uniform(0.1, 5.0) edge weights."""
    g = jgen.planted_partition(8, 40, 0.3, 0.02, seed=seed)[0]
    src, dst = (np.asarray(x)[:g.num_edges] for x in (g.src, g.dst))
    e = np.stack([src, dst], 1)[src < dst]
    w = np.random.default_rng(seed).uniform(0.1, 5.0, size=len(e))
    return jcore.graph.build_graph(e, w.astype(np.float32), n=g.n)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_labels", [3, 40, 0])
def test_scan_run_sums_equal_segment_sum_bit_for_bit(seed, n_labels):
    """Real weights: each (source, label) run sum equals the JAX package's
    ``jax.ops.segment_sum`` in every bit (both fold the run in index order
    from 0.0); a few labels give long runs.  ``n_labels=0``: labels are
    the vertex ids (the first sweep)."""
    jg = real_planted(seed)
    tg = port_of(jg)
    rng = np.random.default_rng(seed + 50)
    labels = (rng.integers(0, n_labels, size=jg.n) if n_labels
              else np.arange(jg.n)).astype(np.int32)
    js, jl, jw, jv = (np.asarray(x) for x in
                      jlpa._scan_communities(jg, jnp.asarray(labels)))
    ts, tl, tw, tv = (x.numpy() for x in
                      tlpa._scan_communities(tg, torch.from_numpy(labels)))
    assert np.array_equal(jv, tv) and jv.sum() > 0
    assert np.array_equal(js[jv], ts[tv]) and np.array_equal(jl[jv], tl[tv])
    assert np.array_equal(jw[jv].view(np.int32), tw[tv].view(np.int32))


def test_segment_sum_folds_in_index_order():
    """``segment_sum`` on unsorted ids equals a left fold in index order
    from 0.0 per segment, bit for bit, and empty segments give 0."""
    rng = np.random.default_rng(9)
    seg = rng.integers(0, 50, size=4000)
    seg[seg == 7] = 8                       # segment 7 stays empty
    val = rng.uniform(0.1, 5.0, size=4000).astype(np.float32)
    want = np.zeros(60, np.float32)
    for s, v in zip(seg, val):
        want[s] = np.float32(want[s] + v)
    got = tlpa.segment_sum(torch.from_numpy(val), torch.from_numpy(seg), 60)
    assert np.array_equal(want.view(np.int32), got.numpy().view(np.int32))
