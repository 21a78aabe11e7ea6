"""PyTorch port, the paper's LPA baselines: ``repro_torch.core.baselines``
against the JAX package's ``repro.core.baselines`` on the inputs of
``tests/test_baselines.py``.

``flpa_host`` and ``igraph_lpa_host`` are host code (the same random
draws); ``networkit_plp`` sweeps ``core.lpa.lpa_move`` with
``device="cpu"``.  Labels must be equal, and Split-Last must repair every
baseline's internally-disconnected communities as the reference's does.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import graphgen as jgen  # noqa: E402
from repro.core import disconnected_fraction as j_disconnected  # noqa: E402
from repro.core import modularity as j_modularity  # noqa: E402
from repro.core import split_lp as j_split_lp  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.core.baselines import (  # noqa: E402
    flpa_host as j_flpa,
    igraph_lpa_host as j_igraph,
    networkit_plp as j_plp,
)
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    flpa_host,
    igraph_lpa_host,
    networkit_plp,
)
from repro_torch.core.detect import disconnected_fraction  # noqa: E402
from repro_torch.core.modularity import modularity  # noqa: E402
from repro_torch.core.split import split_lp  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def _plp_cpu(g, **kw):
    return networkit_plp(g, device="cpu", **kw)


BASELINES = {"flpa": (j_flpa, flpa_host),
             "igraph": (j_igraph, igraph_lpa_host),
             "networkit_plp": (j_plp, _plp_cpu)}
GRAPHS = {
    "ring_of_cliques": lambda: jgen.ring_of_cliques(8, 5),
    "planted": lambda: jgen.planted_partition(6, 30, 0.35, 0.004,
                                              seed=5)[0],
    "karate": lambda: jgen.karate_club()[0],
}


@functools.lru_cache(maxsize=None)
def ref_labels(name, graph):
    """The reference baseline's labels (its PLP sweeps run eagerly and
    take seconds, so each runs once here)."""
    return BASELINES[name][0](GRAPHS[graph]())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_matches_reference(name, graph):
    g = GRAPHS[graph]()
    want, got = ref_labels(name, graph), BASELINES[name][1](port_of(g))
    assert got.dtype == np.int32 and got.shape == (g.n,)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_valid_labeling(name):
    g = jgen.ring_of_cliques(8, 5)
    lab = BASELINES[name][1](port_of(g))
    for q in range(8):
        assert len(set(lab[q * 5:(q + 1) * 5].tolist())) == 1


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_planted_quality_matches_reference(name):
    g = GRAPHS["planted"]()
    lab = BASELINES[name][1](port_of(g))
    q = float(modularity(port_of(g), torch.from_numpy(lab)))
    want = float(j_modularity(g, jnp.asarray(ref_labels(name, "planted"))))
    assert q > 0.4, q
    assert q == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_split_fixes_baseline_disconnection(name, seed):
    """Split-Last as a post-processing step of any LPA: the port's split of
    the port's baseline equals the reference's, with no disconnected
    community."""
    g = jgen.planted_partition(5, 25, 0.3, 0.01, seed=seed)[0]
    ref, port = BASELINES[name]
    pg = port_of(g)
    lab = port(pg)
    fixed = split_lp(pg, torch.from_numpy(lab)).labels
    want = j_split_lp(g, jnp.asarray(ref(g))).labels
    assert np.array_equal(fixed.numpy(), np.asarray(want))
    assert float(disconnected_fraction(pg, fixed)) == 0.0
    assert float(j_disconnected(g, want)) == 0.0


@pytest.mark.parametrize("kw", [dict(seed=1), dict(seed=7, max_passes=2),
                                dict(seed=3, max_passes=1)])
def test_igraph_seeds_and_pass_limits(kw):
    g = jgen.planted_partition(5, 25, 0.3, 0.01, seed=2)[0]
    assert np.array_equal(j_igraph(g, **kw), igraph_lpa_host(port_of(g), **kw))


@pytest.mark.parametrize("kw", [dict(max_passes=1), dict(max_passes=3)])
def test_flpa_visit_limits(kw):
    g = jgen.erdos_renyi(150, 4.0, seed=4)
    assert np.array_equal(j_flpa(g, **kw), flpa_host(port_of(g), **kw))


@pytest.mark.parametrize("kw", [dict(theta=10.0), dict(max_iterations=1),
                                dict(max_iterations=3, theta=0.5)])
def test_networkit_plp_threshold_and_cap(kw):
    g = jgen.planted_partition(6, 30, 0.35, 0.004, seed=5)[0]
    assert np.array_equal(j_plp(g, **kw), _plp_cpu(port_of(g), **kw))


def test_edgeless_graph():
    g = jbuild(np.zeros((0, 2), np.int64), n=5)
    for ref, port in BASELINES.values():
        assert np.array_equal(ref(g), port(port_of(g)))
