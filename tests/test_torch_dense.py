"""PyTorch port, the dense tile path and the dense oracle: ``core.dense``
(``lpa_run_dense`` over B1, ``split_lp_dense`` over B2) and
``core.lpa.lpa_move_reference`` against the JAX package on the same
numpy-seeded graphs, run as the JAX package's own tests run them
(``mode="ref"``, and ``mode="interpret"`` on karate club).

Labels and iteration counts must be equal.  The port runs on the CPU,
where the kernels take their plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import random_graph  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro.core import lpa as jlpa  # noqa: E402
from repro.core import dense as jdense  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import dense  # noqa: E402
from repro_torch.core.lpa import (  # noqa: E402
    lpa_move,
    lpa_move_reference,
    lpa_run,
)
from repro_torch.core.split import split_lp  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def jax_dense_run(g, mode="ref", **kw):
    labels, iters = jdense.lpa_run_dense(jdense.pad_graph(g), mode=mode,
                                         **kw)
    return np.asarray(labels), int(iters)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lpa_run_dense_matches_reference(seed):
    """The reference's ``test_dense_path`` graphs (real weights): the
    port's dense run equals the JAX package's and the port's sparse run."""
    g = random_graph(40 + seed * 17, 5.0, seed=seed, weighted=True)
    want_labels, want_iters = jax_dense_run(g)
    pg = dense.pad_graph(port_of(g))
    labels, iters = dense.lpa_run_dense(pg)
    assert np.array_equal(labels.numpy(), want_labels)
    assert iters == want_iters
    sparse = lpa_run(port_of(g))
    assert np.array_equal(sparse.labels.numpy(), labels.numpy())
    assert sparse.iteration == iters


@pytest.mark.parametrize("tau,max_iterations", [(0.05, 20), (0.0, 3),
                                                (0.3, 20)])
def test_lpa_run_dense_threshold_and_cap_match_reference(tau,
                                                         max_iterations):
    g = jgen.erdos_renyi(120, 6.0, seed=5)
    want = jax_dense_run(g, tau=tau, max_iterations=max_iterations)
    labels, iters = dense.lpa_run_dense(dense.pad_graph(port_of(g)), tau=tau,
                                        max_iterations=max_iterations)
    assert np.array_equal(labels.numpy(), want[0]) and iters == want[1]


def test_dense_path_with_interpret_kernels():
    """Karate club: the JAX package's Pallas kernels in interpret mode and
    its oracle agree, and so does the port."""
    g, _ = jgen.karate_club()
    ref_out = jax_dense_run(g, mode="ref")
    pal_out = jax_dense_run(g, mode="interpret")
    labels, iters = dense.lpa_run_dense(dense.pad_graph(port_of(g)))
    for want in (ref_out, pal_out):
        assert np.array_equal(labels.numpy(), want[0]) and iters == want[1]


@pytest.mark.parametrize("name", ["karate", "planted", "random"])
def test_split_lp_dense_matches_reference(name):
    g = {"karate": lambda: jgen.karate_club()[0],
         "planted": lambda: jgen.planted_partition(5, 30, 0.3, 0.01,
                                                   seed=1)[0],
         "random": lambda: random_graph(90, 2.5, seed=4)}[name]()
    comm = np.array(jlpa.lpa_run(g).labels)
    want, want_iters = jdense.split_lp_dense(jdense.pad_graph(g),
                                             jnp.asarray(comm), mode="ref")
    tg = port_of(g)
    tcomm = torch.from_numpy(comm)
    for rows in (g.n, g.n + 5):   # padding rows carry community -1
        labels, iters = dense.split_lp_dense(dense.pad_graph(tg, rows=rows),
                                             tcomm)
        assert np.array_equal(labels.numpy(), np.asarray(want))
        assert iters == int(want_iters)
    sparse = split_lp(tg, tcomm)
    assert np.array_equal(sparse.labels.numpy(), np.asarray(want))
    assert sparse.iterations == int(want_iters)


def test_lpa_move_dense_matches_reference():
    """One sweep from a random state, hash seeds 0, 7 and -1."""
    g = jgen.erdos_renyi(100, 5.0, seed=2)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 100, size=100).astype(np.int32)
    active = rng.random(100) < 0.7
    jpg = jdense.pad_graph(g)
    pad = jpg.n_pad - g.n
    pg = dense.pad_graph(port_of(g))
    jlabels = jnp.asarray(np.concatenate(
        [labels, np.arange(100, 100 + pad, dtype=np.int32)]))
    jactive = jnp.asarray(np.concatenate([active, np.zeros(pad, bool)]))
    for seed in (0, 7, -1):
        want = jdense.lpa_move_dense(jpg, jlabels, jactive, seed, mode="ref")
        got = dense.lpa_move_dense(pg, torch.from_numpy(labels),
                                   torch.from_numpy(active), seed)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])[:100])
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])[:100])
        assert int(got[2]) == int(want[2])
    changed = torch.from_numpy(rng.random(100) < 0.1)
    want_wake = np.asarray(jdense.neighbors_of_dense(
        jpg, jnp.asarray(np.concatenate([changed.numpy(),
                                         np.zeros(pad, bool)]))))[:100]
    assert np.array_equal(dense.neighbors_of_dense(pg, changed).numpy(),
                          want_wake)


def test_pad_graph_shapes():
    g = port_of(jgen.karate_club()[0])
    pg = dense.pad_graph(g)
    assert (pg.n, pg.n_pad, pg.d_max) == (34, 34, 17)
    pg = dense.pad_graph(g, d_max=32, rows=40)
    assert (pg.n, pg.n_pad, pg.d_max) == (34, 40, 32)
    assert pg.nbr.shape == pg.nw.shape == pg.nmask.shape == (40, 32)
    assert not pg.nmask[34:].any()


@pytest.mark.parametrize("seed", range(6))
def test_lpa_move_reference_matches_reference(seed):
    """The dense O(n^2) oracle on random small graphs (integer weights,
    some with parallel edges merged to weight 2+), random labels and
    active sets: equal to the JAX package's oracle and to the sparse
    ``lpa_move``."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(5, 60))
    g = random_graph(n, float(rng.uniform(1.0, 6.0)), seed=seed)
    labels = rng.integers(0, n, size=n).astype(np.int32)
    active = rng.random(n) < 0.8
    it = int(rng.integers(0, 40))
    want = jlpa.lpa_move_reference(g, jnp.asarray(labels),
                                   jnp.asarray(active), it)
    tg = port_of(g)
    got = lpa_move_reference(tg, torch.from_numpy(labels),
                             torch.from_numpy(active), it)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    sparse = lpa_move(tg, torch.from_numpy(labels), torch.from_numpy(active),
                      it)
    assert np.array_equal(sparse[0].numpy(), got[0].numpy())
