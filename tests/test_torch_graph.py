"""PyTorch port, graph layer: CSR construction, fingerprints, generators and
padded neighbor tiles against the JAX package on the same inputs."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import graph as jgraph  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch import graphgen as tgen  # noqa: E402

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
REPO = Path(__file__).resolve().parents[1]


def port_of(g):
    """The JAX graph's arrays, carried into the port."""
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS),
        device="cpu")


def assert_same_graph(jg, tg):
    assert (tg.n, tg.m_pad, tg.num_edges) == (jg.n, jg.m_pad, jg.num_edges)
    for f in FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert tgraph.graph_fingerprint(tg) == jgraph.graph_fingerprint(jg)


def _edge_list(seed, n, m, weighted):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2))
    e[: m // 10] = e[m // 10: 2 * (m // 10)]      # duplicates to merge
    e[-3:, 1] = e[-3:, 0]                          # self loops to drop
    w = rng.uniform(0.5, 4.0, size=m).astype(np.float32) if weighted \
        else None
    return e, w


@pytest.mark.parametrize("seed,n,m", [(0, 20, 40), (1, 60, 300),
                                      (2, 200, 150), (3, 1, 0)])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_graph_matches_reference(seed, n, m, weighted):
    e, w = _edge_list(seed, n, m, weighted)
    if m == 0:
        e = np.zeros((0, 2), np.int64)
    jg = jgraph.build_graph(e, w, n=n)
    tg = tgraph.build_graph(e, w, n=n)
    assert_same_graph(jg, tg)


def test_build_graph_asymmetric_and_default_n():
    e = np.array([[0, 3], [3, 1], [2, 2], [0, 3]])
    for sym in (True, False):
        assert_same_graph(jgraph.build_graph(e, symmetrize=sym),
                          tgraph.build_graph(e, symmetrize=sym))


@pytest.mark.parametrize("make", [
    lambda m: m.erdos_renyi(150, 6.0, seed=4),
    lambda m: m.planted_partition(5, 20, 0.3, 0.02, seed=2)[0],
    lambda m: m.sbm([10, 30, 20], 0.4, 0.05, seed=9)[0],
    lambda m: m.rmat(7, 4, seed=1),
    lambda m: m.grid2d(9),
    lambda m: m.ring_of_cliques(4, 5),
    lambda m: m.karate_club()[0],
    lambda m: m.figure1_graph()[0],
], ids=["er", "planted", "sbm", "rmat", "grid", "ring", "karate", "fig1"])
def test_generators_match_reference(make):
    jg, tg = make(jgen), make(tgen)
    assert_same_graph(jg, tg)
    assert_same_graph(jg, port_of(jg))


def test_generator_side_outputs_match():
    assert np.array_equal(jgen.sbm([8, 12], 0.5, 0.1, seed=3)[1],
                          tgen.sbm([8, 12], 0.5, 0.1, seed=3)[1])
    assert np.array_equal(jgen.karate_club()[1], tgen.karate_club()[1])
    for a, b in zip(jgen.figure1_graph()[1:], tgen.figure1_graph()[1:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_weighted_planted_partition_matches_jax_build(seed):
    """The real-weight planted partition: the JAX generator's edges, each
    weighted uniform(0.1, 5.0) from the seed, as the JAX package builds
    them."""
    jg = jgen.planted_partition(6, 30, 0.3, 0.02, seed=seed)[0]
    src, dst = (np.asarray(x)[:jg.num_edges] for x in (jg.src, jg.dst))
    e = np.stack([src, dst], 1)[src < dst]
    w = np.random.default_rng(seed).uniform(0.1, 5.0, size=len(e))
    want = jgraph.build_graph(e, w.astype(np.float32), n=jg.n)
    got = tgen.weighted_planted_partition(6, 30, 0.3, 0.02, seed=seed)
    assert_same_graph(want, got)
    assert np.unique(np.asarray(want.wgt)[:want.num_edges]).size > 100


def test_fingerprint_recomputed_from_tensors():
    tg = tgen.erdos_renyi(80, 4.0, seed=5)
    fp = tgraph.graph_fingerprint(tg)
    object.__delattr__(tg, "_fingerprint")
    assert tgraph.graph_fingerprint(tg) == fp
    assert tg.to("cpu") is tg


def test_graph_from_arrays_rejects_bad_shapes():
    jg = jgen.karate_club()[0]
    arrays = [np.asarray(getattr(jg, f)) for f in FIELDS]
    with pytest.raises(ValueError):
        tgraph.graph_from_arrays(jg.n + 1, jg.num_edges, *arrays)
    bad = list(arrays)
    bad[2] = bad[2][:-1]
    with pytest.raises(ValueError):
        tgraph.graph_from_arrays(jg.n, jg.num_edges, *bad)


@pytest.mark.parametrize("make", [
    lambda m: m.erdos_renyi(90, 5.0, seed=3),
    lambda m: m.figure1_graph()[0],
    lambda m: m.grid2d(6),
], ids=["er", "fig1", "grid"])
@pytest.mark.parametrize("extra_rows", [0, 13])
def test_padded_neighbors_match_reference(make, extra_rows):
    """Vectorised tiles == the reference's per-row loop on the real
    (rows, degree) block; padding slots point at their own row with
    weight 0 and mask False, whatever the tile width."""
    jg = make(jgen)
    tg = port_of(jg)
    jn, jw, jm = jgraph.to_padded_neighbors(jg)
    d = int(np.asarray(jg.row_ptr[1:] - jg.row_ptr[:-1]).max())
    rows = jg.n + extra_rows
    for width in (d, d + 3):
        tn, tw, tm = (x.numpy() for x in
                      tgraph.to_padded_neighbors(tg, d_max=width, rows=rows))
        assert tn.shape == (rows, width) and tn.dtype == np.int32
        assert tw.dtype == np.float32 and tm.dtype == bool
        k = min(width, jn.shape[1])
        assert np.array_equal(tm[: jg.n, :k], jm[: jg.n, :k])
        assert np.array_equal(tn[: jg.n, :k], jn[: jg.n, :k])
        assert np.array_equal(tw[: jg.n, :k], jw[: jg.n, :k])
        pad = ~tm
        own = np.broadcast_to(np.arange(rows)[:, None], tn.shape)
        assert np.array_equal(tn[pad], own[pad])
        assert not tw[pad].any()


def test_padded_neighbors_truncate_wide_rows():
    tg = tgen.karate_club()[0]
    tn, tw, tm = tgraph.to_padded_neighbors(tg, d_max=3)
    deg = (tg.row_ptr[1:] - tg.row_ptr[:-1]).numpy()
    assert np.array_equal(tm.sum(1).numpy(), np.minimum(deg, 3))
    first = tg.dst[tg.row_ptr[:-1].long()].numpy()
    assert np.array_equal(tn[:, 0].numpy()[deg > 0], first[deg > 0])


def test_numpy_adjacency_matches_reference():
    jg = jgen.planted_partition(3, 10, 0.5, 0.1, seed=1)[0]
    assert tgraph.to_numpy_adj(port_of(jg)) == jgraph.to_numpy_adj(jg)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py",
              *sorted((REPO / "examples").glob("*_torch.py"))]
    assert len(files) > 15
    rel = {str(f.relative_to(REPO)) for f in files}
    for must in ("serve/service.py", "serve/admission.py", "serve/health.py",
                 "serve/loadgen.py", "checkpoint/manager.py",
                 "launch/serve.py", "launch/mesh.py", "core/distributed.py",
                 "engine/backends/sharded.py", "core/baselines.py",
                 "core/metrics.py", "models/moe.py", "models/mamba.py",
                 "models/rwkv.py"):
        assert f"src/repro_torch/{must}" in rel, must
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)
