"""PyTorch port, multi-device detection: ``repro_torch.core.distributed``
and the ``sharded`` backend against the JAX package's
``repro.core.distributed`` and its ``sharded`` backend.

Two subprocesses run side by side, each with its own deadline:

  * the reference on 4 host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, the pattern
    of ``tests/test_distributed.py``), mesh (2, 2);
  * the port on 4 gloo ranks (``launch.mesh.spawn_ranks``, a ``file://``
    store), ``DeviceMesh`` (2, 2), ``device="cpu"``.

Each runs ``distributed_gsl_lpa`` and ``Engine(EngineConfig(backend=
"sharded", mesh=..., exchange_every=k))`` for k in 1, 2, 3 on three graphs
(one with n not a multiple of 32, with integer weights, so every sum is
exact) and restores one checkpoint onto the mesh.  Labels, both iteration
counts and the checkpoint callbacks must be equal, on every rank; at k=1
they must also equal the port's single-process tile and segment fits.

The in-process tests run the backend with no process group (one rank)
against the reference's one-device mesh.
"""
import inspect
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.core.graph import build_graph as jbuild  # noqa: E402
from repro.engine import CompileCache, Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.detect import disconnected_fraction  # noqa: E402
from repro_torch.core.distributed import distributed_gsl_lpa  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    PLAN_LOG,
    Engine,
    EngineConfig,
    PlanCache,
    choose_backend,
    choose_backend_batch,
    get_backend,
)
from repro_torch.engine.bucketing import bucket_for  # noqa: E402
from repro_torch.engine.config import UNPORTED  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
KS = (1, 2, 3)
GRAPH_NAMES = ("karate", "planted", "intw203")
# Each subprocess's deadline; both take ~5-20 s here.
TIMEOUT_S = 240
JAX_CACHE = CompileCache()


def make_graphs(gen, build_graph):
    """The graphs, built the same way here and in both subprocesses."""
    rng = np.random.default_rng(3)
    e = rng.integers(0, 203, size=(420, 2))
    w = rng.integers(1, 5, size=420).astype(np.float32)
    return {"karate": gen.karate_club()[0],
            "planted": gen.planted_partition(6, 40, 0.3, 0.01, seed=2)[0],
            "intw203": build_graph(e, w, n=203)}


GRAPH_CODE = "import numpy as np\n\n" + inspect.getsource(make_graphs)

# The checkpoint both sides restore onto their (2, 2) mesh: leaf ->
# (the reference's PartitionSpec, the port's placements).
CKPT_SPECS = {
    "w": ("P('data', None)", "[Shard(0), Replicate()]"),
    "b": ("P(('data', 'model'))", "[Shard(0), Shard(0)]"),
    "m": ("P(None, 'model')", "[Replicate(), Shard(1)]"),
    "step": ("P()", "[Replicate(), Replicate()]"),
}

REF_SCRIPT = GRAPH_CODE + textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import graphgen
    from repro.checkpoint import CheckpointManager
    from repro.core.graph import build_graph
    from repro.core.distributed import distributed_gsl_lpa
    from repro.engine import CompileCache, Engine, EngineConfig
    from repro.launch.mesh import make_host_mesh

    out_path, ckpt_dir, specs = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    mesh = make_host_mesh((2, 2), ("data", "model"))
    out = {"devices": jax.device_count()}
    for name, g in make_graphs(graphgen, build_graph).items():
        for k in (1, 2, 3):
            calls = []
            labels, it, sit = distributed_gsl_lpa(
                g, mesh, exchange_every=k,
                checkpoint_cb=lambda ph, i, l: calls.append(
                    (ph, i, np.asarray(l))))
            r = Engine(EngineConfig(backend="sharded", mesh=mesh,
                                    exchange_every=k),
                       cache=CompileCache()).fit(g)
            out[name, k] = {"dist": (np.asarray(labels), it, sit),
                            "calls": calls,
                            "fit": (r.labels, r.lpa_iterations,
                                    r.split_iterations)}
    mgr = CheckpointManager(ckpt_dir)
    named, _, _ = mgr.load_named()
    target = {k: jnp.zeros(v.shape, v.dtype) for k, v in named.items()}
    sh = {k: NamedSharding(mesh, eval(spec)) for k, (spec, _) in specs.items()}
    tree, _, _ = mgr.restore(target, shardings=sh)
    out["ckpt"] = {k: np.asarray(v) for k, v in tree.items()}
    out["ckpt_shards"] = {k: len(v.addressable_shards)
                          for k, v in tree.items()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""")

PORT_SCRIPT = GRAPH_CODE + textwrap.dedent("""
    import pickle, sys
    import torch

    def rank_fn(rank, world, ckpt_dir, specs):
        torch.set_num_threads(1)
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch import graphgen
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.core.graph import build_graph
        from repro_torch.core.distributed import distributed_gsl_lpa
        from repro_torch.engine import Engine, EngineConfig, PlanCache
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh((2, 2), ("data", "model"))
        out = {"world": world, "rank": rank}
        for name, g in make_graphs(graphgen, build_graph).items():
            for k in (1, 2, 3):
                calls = []
                labels, it, sit = distributed_gsl_lpa(
                    g, mesh, exchange_every=k, device="cpu",
                    checkpoint_cb=lambda ph, i, l: calls.append(
                        (ph, i, l.numpy().copy())))
                cfg = EngineConfig(backend="sharded", mesh=mesh,
                                   exchange_every=k, device="cpu")
                r = Engine(cfg, cache=PlanCache()).fit(g)
                out[name, k] = {"dist": (labels, it, sit), "calls": calls,
                                "fit": (r.labels, r.lpa_iterations,
                                        r.split_iterations)}
        # auto picks sharded with 4 ranks and no mesh given
        r = Engine(EngineConfig(device="cpu"), cache=PlanCache()).fit(g)
        out["auto"] = (r.backend, r.labels, r.lpa_iterations,
                       r.split_iterations)
        mgr = CheckpointManager(ckpt_dir)
        named, _, _ = mgr.load_named()
        target = {k: torch.from_numpy(v.copy()) * 0
                  for k, v in named.items()}
        sh = {k: (mesh, eval(p)) for k, (_, p) in specs.items()}
        tree, _, _ = mgr.restore(target, shardings=sh)
        out["ckpt"] = {k: v.full_tensor().numpy() for k, v in tree.items()}
        out["ckpt_local"] = {k: tuple(v.to_local().shape)
                             for k, v in tree.items()}
        return out

    if __name__ == "__main__":
        from repro_torch.launch.mesh import spawn_ranks
        out_path, ckpt_dir, specs = sys.argv[1], sys.argv[2], \\
            eval(sys.argv[3])
        res = spawn_ranks(rank_fn, 4, (ckpt_dir, specs), timeout=%d)
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
""" % (TIMEOUT_S - 30))


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def ref_graphs():
    return make_graphs(jgen, jbuild)


def _ckpt_tree():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(10, 3)).astype(np.float32),
            "b": rng.integers(-9, 9, size=12).astype(np.int32),
            "m": rng.normal(size=(4, 6)).astype(np.float32),
            "step": np.int32(41)}


def _run_both(tmp: Path) -> tuple[dict, list]:
    """Start the reference and the port subprocesses together; wait for
    both, killing either at its deadline."""
    ckpt = tmp / "ckpt"
    CheckpointManager(ckpt).save(3, _ckpt_tree())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    specs = repr({k: v for k, v in CKPT_SPECS.items()})
    procs = {}
    for side, script in (("ref", REF_SCRIPT), ("port", PORT_SCRIPT)):
        path = tmp / f"{side}_script.py"
        path.write_text(script)
        procs[side] = subprocess.Popen(
            [sys.executable, str(path), str(tmp / f"{side}.pkl"), str(ckpt),
             specs], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT_S
    errors = {}
    for side, proc in procs.items():
        try:
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            proc.communicate()
            raise AssertionError(f"{side} subprocess outlived {TIMEOUT_S} s")
        if proc.returncode != 0:
            errors[side] = err[-4000:]
    assert not errors, errors
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("dist"))


@pytest.fixture(scope="module")
def single_process():
    """The port's single-process tile and segment fits of each graph."""
    out = {}
    for name, g in ref_graphs().items():
        for backend in ("tile", "segment"):
            r = Engine(EngineConfig(device="cpu", backend=backend),
                       cache=PlanCache()).fit(port_of(g))
            out[name, backend] = (r.labels, r.lpa_iterations,
                                  r.split_iterations)
    return out


def _same(a, b) -> bool:
    """Equal nested (labels, counts, call lists)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


CASES = [(g, k) for g in GRAPH_NAMES for k in KS]


def test_four_ranks_ran(runs):
    ref, port = runs
    assert ref["devices"] == 4
    assert [r["rank"] for r in port] == [0, 1, 2, 3]
    assert all(r["world"] == 4 for r in port)


@pytest.mark.parametrize("name,k", CASES)
def test_every_rank_returns_the_same(runs, name, k):
    _, port = runs
    for r in port[1:]:
        assert _same(r[name, k], port[0][name, k]), r["rank"]


@pytest.mark.parametrize("name,k", CASES)
def test_distributed_gsl_lpa_matches_reference(runs, name, k):
    ref, port = runs
    want, got = ref[name, k], port[0][name, k]
    assert _same(want["dist"], got["dist"]), (want["dist"][1:],
                                              got["dist"][1:])


@pytest.mark.parametrize("name,k", CASES)
def test_checkpoint_callbacks_match_reference(runs, name, k):
    ref, port = runs
    want, got = ref[name, k]["calls"], port[0][name, k]["calls"]
    assert [c[:2] for c in want] == [c[:2] for c in got]
    assert {c[0] for c in got} == {"lpa", "split"}
    assert _same(want, got)


@pytest.mark.parametrize("name,k", CASES)
def test_sharded_fit_matches_reference(runs, name, k):
    ref, port = runs
    want, got = ref[name, k]["fit"], port[0][name, k]["fit"]
    assert _same(want, got), (want[1:], got[1:])


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_exchange_every_1_equals_single_process_fits(runs, single_process,
                                                     name):
    _, port = runs
    got = port[0][name, 1]
    for backend in ("tile", "segment"):
        want = single_process[name, backend]
        assert _same(want, got["fit"]), backend
        assert _same(want[1:], got["dist"][1:]), backend
    # distributed_gsl_lpa's labels are uncompacted split roots
    fit_labels = got["fit"][0]
    _, compact = np.unique(got["dist"][0], return_inverse=True)
    assert np.array_equal(compact, fit_labels)


@pytest.mark.parametrize("name,k", CASES)
def test_no_disconnected_community(runs, name, k):
    _, port = runs
    g = port_of(ref_graphs()[name])
    for labels in (port[0][name, k]["fit"][0], port[0][name, k]["dist"][0]):
        assert float(disconnected_fraction(
            g, torch.from_numpy(np.asarray(labels)))) == 0.0


def test_auto_picks_sharded_on_four_ranks(runs, single_process):
    _, port = runs
    backend, *fit = port[0]["auto"]
    assert backend == "sharded"
    assert _same(single_process["intw203", "tile"], tuple(fit))


@pytest.mark.parametrize("leaf", sorted(CKPT_SPECS))
def test_checkpoint_restore_on_2x2_mesh(runs, leaf):
    """Each rank's DTensor gathers to the stored array bit for bit, as the
    reference's restore onto its (2, 2) mesh does."""
    ref, port = runs
    want = _ckpt_tree()[leaf]
    assert np.asarray(ref["ckpt"][leaf]).tobytes() == np.asarray(
        want).tobytes()
    for r in port:
        got = r["ckpt"][leaf]
        assert got.dtype == np.asarray(want).dtype
        assert got.tobytes() == np.asarray(want).tobytes(), r["rank"]
    if leaf == "w":   # rows split over "data" only
        assert {r["ckpt_local"]["w"] for r in port} == {(5, 3)}
    if leaf == "b":   # over all four ranks
        assert {r["ckpt_local"]["b"] for r in port} == {(3,)}


# --- one rank, no process group, against the reference's one-device mesh

def _fit_pair(g, k=1, **cfg):
    want = JEngine(JConfig(backend="sharded", exchange_every=k, **cfg),
                   cache=JAX_CACHE).fit(g)
    got = Engine(EngineConfig(backend="sharded", exchange_every=k,
                              device="cpu", **cfg),
                 cache=PlanCache()).fit(port_of(g))
    return want, got


def _assert_same_fit(want, got):
    assert np.array_equal(want.labels, got.labels)
    assert (want.lpa_iterations, want.split_iterations,
            want.num_communities) == (got.lpa_iterations,
                                      got.split_iterations,
                                      got.num_communities)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ("karate", "intw203"))
def test_one_rank_matches_reference(name, k):
    g = ref_graphs()[name]
    want, got = _fit_pair(g, k)
    assert got.backend == "sharded"
    _assert_same_fit(want, got)
    if k == 1:
        tile = Engine(EngineConfig(device="cpu", backend="tile"),
                      cache=PlanCache()).fit(port_of(g))
        _assert_same_fit(tile, got)


@pytest.mark.parametrize("cfg", [
    dict(split="none"), dict(split="bfs_host"), dict(shortcut=True),
    dict(profile="full"), dict(quality="full"), dict(quality="basic"),
    dict(compute_metrics=True)], ids=lambda c: "-".join(
        f"{k}={v}" for k, v in c.items()))
def test_one_rank_options_match_reference(cfg):
    g = ref_graphs()["planted"]
    want, got = _fit_pair(g, **cfg)
    _assert_same_fit(want, got)
    assert want.profile is None and got.profile is None
    if "quality" in cfg:
        assert (want.quality is None) == (got.quality is None)
        assert want.quality.num_communities == got.quality.num_communities
        assert want.quality.disconnected_fraction \
            == got.quality.disconnected_fraction
        if cfg["quality"] == "full":
            assert got.quality.disconnected_fraction == 0.0
    if "compute_metrics" in cfg:
        assert got.disconnected_fraction == want.disconnected_fraction == 0.0
        assert got.modularity == pytest.approx(want.modularity, rel=1e-5)


@pytest.mark.parametrize("k", (1, 2))
def test_one_rank_warm_start_matches_reference(k):
    g = ref_graphs()["intw203"]
    rng = np.random.default_rng(8)
    cold = JEngine(JConfig(backend="segment"), cache=JAX_CACHE).fit(g)
    labels = cold.labels.astype(np.int32)
    # warm labels must be vertex ids: each community's smallest member
    roots = np.full(labels.max() + 1, g.n, np.int64)
    np.minimum.at(roots, labels, np.arange(g.n))
    warm = roots[labels].astype(np.int32)
    frontier = rng.random(g.n) < 0.2
    for kw in (dict(init_labels=warm),
               dict(init_labels=warm, init_active=frontier)):
        want = JEngine(JConfig(backend="sharded", exchange_every=k),
                       cache=JAX_CACHE).fit(g, **kw)
        got = Engine(EngineConfig(backend="sharded", exchange_every=k,
                                  device="cpu"),
                     cache=PlanCache()).fit(port_of(g), **kw)
        _assert_same_fit(want, got)
        assert got.warm_started


def test_one_rank_refusals_match_reference():
    g = ref_graphs()["karate"]
    with pytest.raises(ValueError, match="lp"):
        JEngine(JConfig(backend="sharded", split="lpp"),
                cache=CompileCache()).fit(g)
    with pytest.raises(ValueError, match="'lp'"):
        Engine(EngineConfig(backend="sharded", split="lpp", device="cpu"),
               cache=PlanCache()).fit(port_of(g))
    # out of core: the reference's ValueError naming partitions
    with pytest.raises(ValueError, match="partition"):
        JEngine(JConfig(backend="sharded"),
                cache=CompileCache()).fit(g, memory_budget=256)
    with pytest.raises(ValueError, match="partition"):
        Engine(EngineConfig(backend="sharded", device="cpu"),
               cache=PlanCache()).fit(port_of(g), memory_budget=256)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="exchange_every"):
            JConfig(exchange_every=bad)
        with pytest.raises(ValueError, match="exchange_every"):
            EngineConfig(exchange_every=bad, device="cpu")


def test_fit_many_equals_sequential_fits():
    graphs = [ref_graphs()[n] for n in GRAPH_NAMES]
    eng = Engine(EngineConfig(backend="sharded", device="cpu"),
                 cache=PlanCache())
    many = eng.fit_many([port_of(g) for g in graphs])
    want = JEngine(JConfig(backend="sharded"),
                   cache=JAX_CACHE).fit_many(graphs)
    for w, m, g in zip(want, many, graphs):
        _assert_same_fit(w, m)
        _assert_same_fit(eng.fit(port_of(g)), m)
        assert m.backend == "sharded" and m.batch_size == 1


def test_config_and_registry_take_the_sharded_options():
    cfg = EngineConfig(backend="sharded", exchange_every=2, device="cpu")
    assert cfg.exchange_every == 2
    assert get_backend("sharded").name == "sharded"
    assert not get_backend("sharded").supports_batch
    # LM serving and training are ported for one device and a mesh
    # (A15.2, A15.3), B5-bwd with a window too; what is left is B5's
    # head dims, naming its ROADMAP item
    assert "lm serving" not in UNPORTED
    assert set(UNPORTED) == {
        "attention head dims other than 64 and 128 on CUDA"}
    assert all(item.startswith("Queue B") for item in UNPORTED.values())
    assert not any(k.startswith("parallel/") for k in UNPORTED)
    # exchange_every is an algorithm static, as in the reference
    assert cfg.algo_key() != EngineConfig(backend="sharded",
                                          device="cpu").algo_key()


@pytest.mark.parametrize("name", ("karate", "planted", "intw203", "er"))
def test_auto_without_a_group_picks_as_before(name):
    """No process group and no mesh: auto keeps the single-device policy
    (tile on CUDA within the limits, else segment)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    g = port_of(ref_graphs()[name] if name != "er"
                else jgen.erdos_renyi(300, 6.0, seed=1))
    cfg = EngineConfig(device="cpu")
    assert choose_backend(g, cfg, torch.device("cpu")) == "segment"
    assert choose_backend(g, cfg, torch.device("cuda")) == "tile"
    assert choose_backend_batch([g, g], cfg, torch.device("cuda")) == "tile"
    assert Engine(cfg, cache=PlanCache()).fit(g).backend == "segment"


def test_plan_log_one_build_per_bucket_mesh_and_k():
    graphs = [port_of(g) for g in ref_graphs().values()]
    before = PLAN_LOG.snapshot()
    cache = PlanCache()
    for k in (1, 2):
        eng = Engine(EngineConfig(backend="sharded", exchange_every=k,
                                  device="cpu"), cache=cache)
        for g in graphs + graphs:
            eng.fit(g)
    after = PLAN_LOG.snapshot()
    built = {t: after.get(t, 0) - before.get(t, 0)
             for t in ("sharded:propagate", "sharded:split")}
    plans = 2 * len({bucket_for(g) for g in graphs})
    assert built == {"sharded:propagate": plans, "sharded:split": plans}
    assert cache.stats() == {"plans": plans, "hits": 4 * len(graphs) - plans,
                             "misses": plans}


def test_refit_after_the_group_is_restarted(tmp_path):
    """An in-process restart: a group destroyed and initialised again gives
    a mesh equal to the old one, and the fits on it must run on the new
    group, not on a resolved mesh or a plan cached with the old."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core.distributed import resolve_shards
    from repro_torch.launch.mesh import make_flat_mesh
    g = port_of(ref_graphs()["intw203"])
    want = Engine(EngineConfig(device="cpu", backend="tile"),
                  cache=PlanCache()).fit(g)
    cache = PlanCache()
    meshes = []
    for attempt in range(2):
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path / f'store{attempt}'}",
            rank=0, world_size=1, timeout=timedelta(seconds=60))
        try:
            meshes.append(make_flat_mesh())
            for mesh in (meshes[-1], None):
                assert resolve_shards(mesh).group is dist.group.WORLD
                misses = cache.stats()["misses"]
                got = Engine(EngineConfig(backend="sharded", mesh=mesh,
                                          device="cpu"), cache=cache).fit(g)
                _assert_same_fit(want, got)
                # a new group is a new plan
                assert cache.stats()["misses"] == misses + 1
        finally:
            dist.destroy_process_group()
    assert meshes[0] == meshes[1]


def test_distributed_gsl_lpa_one_rank_matches_reference():
    from repro.core.distributed import distributed_gsl_lpa as jdist
    from repro.launch.mesh import make_flat_mesh
    g = ref_graphs()["planted"]
    jcalls, calls = [], []
    want = jdist(g, make_flat_mesh(), exchange_every=2,
                 checkpoint_cb=lambda ph, i, l: jcalls.append(
                     (ph, i, np.asarray(l))))
    got = distributed_gsl_lpa(port_of(g), exchange_every=2, device="cpu",
                              checkpoint_cb=lambda ph, i, l: calls.append(
                                  (ph, i, l.numpy().copy())))
    assert _same(want, got)
    assert _same(jcalls, calls)
