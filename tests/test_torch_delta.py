"""PyTorch port, graph deltas: ``core.delta`` and
``graphgen.evolving_sequence`` against the JAX package's.

On the same graphs and deltas the port's ``apply_delta`` and
``apply_delta_patch`` must give the reference's arrays byte for byte
(dtype included) and its fingerprint, and the port's patch must equal the
port's rebuild; ``evolving_sequence`` must draw the reference's deltas for
the same seed.  Inputs come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro.core import delta as jdelta  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.core.graph import graph_fingerprint as jfp  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GraphDelta,
    affected_frontier,
    apply_delta,
    apply_delta_patch,
    undirected_edges,
)
from repro_torch.core import graph as tgraph  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def deltas_of(**kw):
    """The same delta in both packages."""
    return jdelta.GraphDelta.make(**kw), GraphDelta.make(**kw)


def assert_same_graph(want, got, ctx=""):
    """``want``: a JAX-package or port graph; ``got``: a port graph."""
    assert (want.n, want.m_pad, want.num_edges) \
        == (got.n, got.m_pad, got.num_edges), ctx
    for f in FIELDS:
        w = getattr(want, f)
        x = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        y = getattr(got, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f)
    want_fp = tgraph.graph_fingerprint(want) \
        if isinstance(want, tgraph.Graph) else jfp(want)
    assert tgraph.graph_fingerprint(got) == want_fp, ctx


def both_ways(jg, jd, td, ctx=""):
    """Port rebuild and patch against the reference's, and each other."""
    tg = port_of(jg)
    rebuild, patch = apply_delta(tg, td), apply_delta_patch(tg, td)
    assert_same_graph(jdelta.apply_delta(jg, jd), rebuild, ctx)
    assert_same_graph(jdelta.apply_delta_patch(jg, jd), patch, ctx)
    assert_same_graph(rebuild, patch, ctx)
    return rebuild


def adj_dict(graph):
    out = {}
    for u, nbrs in enumerate(tgraph.to_numpy_adj(graph)):
        for v, w in nbrs:
            if u < v:
                out[(u, v)] = w
    return out


# --- GraphDelta ----------------------------------------------------------

def test_make_canonicalises_and_defaults():
    jd, d = deltas_of(insert=[[5, 2], [3, 3], [1, 4]], delete=[[7, 0]])
    assert d.insertions.tolist() == [[2, 5], [1, 4]]
    assert d.insert_weights.tolist() == [1.0, 1.0]
    assert d.deletions.tolist() == [[0, 7]]
    assert d.touched_vertices().tolist() == [0, 1, 2, 4, 5, 7]
    for f in ("insertions", "insert_weights", "deletions"):
        a, b = getattr(jd, f), getattr(d, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not d.is_empty() and GraphDelta.make().is_empty()
    with pytest.raises(ValueError):
        GraphDelta.make(insert=[[0, 1], [1, 2]], weights=[1.0])
    with pytest.raises(ValueError):
        GraphDelta.make(insert=[[-1, 2]])


def test_affected_frontier_matches_reference():
    jd, d = deltas_of(insert=[[0, 3], [2, 11]], delete=[[2, 5]])
    for n in (8, 12):
        f = affected_frontier(d, n)
        assert np.array_equal(f, jdelta.affected_frontier(jd, n))
    assert affected_frontier(d, 8).tolist() == [
        True, False, True, True, False, True, False, False]
    assert not affected_frontier(GraphDelta.make(), 4).any()


def test_undirected_edges_matches_reference():
    jg = jgen.erdos_renyi(60, 4.0, seed=3)
    e, w = undirected_edges(port_of(jg))
    je, jw = jdelta.undirected_edges(jg)
    assert np.array_equal(e, je) and np.array_equal(w, np.asarray(jw))
    assert 2 * len(e) == jg.num_edges and np.all(e[:, 0] < e[:, 1])


# --- apply_delta / apply_delta_patch against the reference --------------

def test_insert_delete_roundtrip():
    jg = jbuild(np.array([[0, 1], [1, 2], [2, 3], [3, 0]]), n=5)
    g2 = both_ways(jg, *deltas_of(insert=[[0, 2], [1, 4]], delete=[[2, 3]]))
    assert adj_dict(g2) == {(0, 1): 1.0, (1, 2): 1.0, (0, 3): 1.0,
                            (0, 2): 1.0, (1, 4): 1.0}


def test_weight_semantics():
    jg = jbuild(np.array([[0, 1], [1, 2]]),
                np.array([2.0, 3.0], np.float32), n=3)
    g2 = both_ways(jg, *deltas_of(insert=[[1, 0]], weights=[0.5]))
    assert adj_dict(g2) == {(0, 1): 2.5, (1, 2): 3.0}
    g3 = both_ways(jg, *deltas_of(delete=[[0, 1], [0, 2]]))
    assert adj_dict(g3) == {(1, 2): 3.0}


def test_weight_merge_order():
    """Merged weights add in float64 in build_graph's order."""
    jg = jbuild(np.array([[0, 1], [1, 2]]),
                np.array([0.1, 0.2], np.float32), n=3)
    both_ways(jg, *deltas_of(insert=[[1, 0], [0, 1], [1, 2]],
                             weights=[0.3, 0.7, 0.111]))


def test_delete_then_reinsert_starts_fresh():
    jg = jbuild(np.array([[0, 1], [1, 2]]),
                np.array([5.0, 1.0], np.float32), n=3)
    g2 = both_ways(jg, *deltas_of(insert=[[0, 1]], weights=[0.25],
                                  delete=[[0, 1]]))
    assert adj_dict(g2)[(0, 1)] == np.float32(0.25)


def test_out_of_range_delete_is_a_no_op():
    """(2, 25) on 10 vertices keys to 2 * 10 + 25 == 45, the key of the real
    edge (4, 5): it must not delete it."""
    jg = jbuild(np.array([[0, 1], [4, 5]]), n=10)
    g2 = both_ways(jg, *deltas_of(delete=[[2, 25]]))
    assert adj_dict(g2) == {(0, 1): 1.0, (4, 5): 1.0}


def test_vertex_growth_never_shrinks():
    jg = jbuild(np.array([[0, 1], [4, 5]]), n=10)
    g2 = both_ways(jg, *deltas_of(insert=[[9, 12]], delete=[[2, 25]],
                                  num_vertices=11))
    assert g2.n == 13
    g3 = both_ways(jg, *deltas_of(num_vertices=16))
    assert g3.n == 16
    tg = port_of(jg)
    for fn in (apply_delta, apply_delta_patch):
        with pytest.raises(ValueError, match="shrinks"):
            fn(tg, GraphDelta.make(num_vertices=3))


def test_empty_delta():
    jg = random_graph(40, 3.0, seed=5, weighted=True)
    tg = port_of(jg)
    assert apply_delta_patch(tg, GraphDelta.make()) is tg
    assert tgraph.graph_fingerprint(apply_delta(tg, GraphDelta.make())) \
        == tgraph.graph_fingerprint(tg) == jfp(jg)


@pytest.mark.parametrize("weighted", (False, True))
def test_randomized_parity_sweep(weighted):
    """Random graphs (weighted ones with duplicate input edges, the kdeg
    order adversary) under random deltas: the port's rebuild and patch
    equal the reference's, byte for byte."""
    rng = np.random.default_rng(11 + weighted)
    for trial in range(40):
        n = int(rng.integers(2, 50))
        jg = random_graph(n, float(rng.uniform(0.5, 6.0)),
                          seed=int(rng.integers(1 << 30)), weighted=weighted)
        live, _ = jdelta.undirected_edges(jg)
        dels = live[rng.integers(0, len(live), size=3)].tolist() \
            if len(live) else []
        ins = rng.integers(0, n + 2, size=(3, 2)).tolist()
        if dels:
            ins.append(dels[0])             # delete + reinsert
        if len(live):
            ins += [live[0].tolist()] * 2   # double merge on one edge
        iw = rng.uniform(0.05, 3.0, size=len(ins)).astype(np.float32) \
            if weighted else None
        jd, td = deltas_of(insert=ins, delete=dels or None, weights=iw)
        if td.is_empty():
            continue
        both_ways(jg, jd, td, f"trial {trial}")


def test_patch_fingerprint_is_precomputed():
    """The patch fingerprints its host arrays once: no CRC on lookup."""
    from unittest import mock
    tg = tgen.grid2d(5)
    patched = apply_delta_patch(tg, GraphDelta.make(insert=[[0, 6]]))
    with mock.patch("zlib.crc32",
                    side_effect=AssertionError("lazy recompute")):
        fp = tgraph.graph_fingerprint(patched)
    assert fp == tgraph.graph_fingerprint(
        apply_delta(tg, GraphDelta.make(insert=[[0, 6]])))


def test_patch_of_a_grid_diagonal_delta():
    """The chip phase's delta shape at a small side: diagonal inserts (a
    lattice never has them) and deletions of existing edges."""
    side = 12
    jg, tg = jgen.grid2d(side), tgen.grid2d(side)
    rng = np.random.default_rng(0)
    live, _ = undirected_edges(tg)
    dels = live[rng.choice(len(live), 8, replace=False)]
    ij = rng.choice((side - 1) * (side - 1), 8, replace=False)
    i, j = ij // (side - 1), ij % (side - 1)
    ins = np.stack([i * side + j, (i + 1) * side + j + 1], axis=1)
    post = both_ways(jg, *deltas_of(insert=ins, delete=dels))
    assert post.num_edges == tg.num_edges


# --- evolving_sequence ---------------------------------------------------

@pytest.mark.parametrize("seed", (0, 7, 101))
def test_evolving_sequence_matches_reference(seed):
    jb, jds = jgen.evolving_sequence(80, 4.0, rounds=4, delta_edges=3,
                                     seed=seed)
    tb, tds = tgen.evolving_sequence(80, 4.0, rounds=4, delta_edges=3,
                                     seed=seed)
    assert tgraph.graph_fingerprint(tb) == jfp(jb)
    assert len(tds) == len(jds) == 4
    g = tb
    for jd, td in zip(jds, tds):
        for f in ("insertions", "insert_weights", "deletions"):
            assert np.array_equal(getattr(jd, f), getattr(td, f)), f
        live = set(map(tuple, undirected_edges(g)[0].tolist()))
        assert all(tuple(e) in live for e in td.deletions.tolist())
        assert all(tuple(e) not in live for e in td.insertions.tolist())
        g = apply_delta(g, td)
    assert g.num_edges == tb.num_edges  # equal churn in and out


def test_evolving_sequence_on_a_given_base():
    jbase = jgen.planted_partition(4, 32, 0.2, 0.01, seed=2)[0]
    tbase = port_of(jbase)
    _, jds = jgen.evolving_sequence(0, 0.0, 3, 16, seed=5, base=jbase)
    out, tds = tgen.evolving_sequence(0, 0.0, 3, 16, seed=5, base=tbase)
    assert out is tbase
    for jd, td in zip(jds, tds):
        assert np.array_equal(jd.insertions, td.insertions)
        assert np.array_equal(jd.deletions, td.deletions)
