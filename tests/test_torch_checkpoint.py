"""PyTorch port, checkpoints: ``repro_torch.checkpoint.CheckpointManager``
against the JAX package's ``repro.checkpoint.CheckpointManager``.

The two write the same files (``step-<k>/arrays.npz`` + ``manifest.json``),
so a checkpoint written by either must restore in the other bit for bit,
bfloat16 included (stored as raw ``uint16`` bits).  Leaves match by name:
JAX flattens dict keys sorted, so the port's trees here are built in
another insertion order on purpose.  Exact everywhere.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_named  # noqa: E402

Pair = collections.namedtuple("Pair", "lo hi")


def _np_tree(seed=0):
    """Host arrays of the shared test tree, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(8, 16)).astype(np.float32),
                   "b": rng.normal(size=(16,)).astype(np.float32)},
        "opt": {"m": rng.normal(size=(8, 16)).astype(np.float32),
                "count": np.int32(7 + seed)},
        "seq": [rng.integers(0, 99, size=5).astype(np.int32),
                (rng.normal(size=(3,)).astype(np.float32),)],
    }


def _port_tree(seed=0):
    """The tree as the port holds it: tensors, ``b`` in bfloat16, dict
    keys in reverse-sorted insertion order."""
    t = _np_tree(seed)
    return {
        "seq": [torch.from_numpy(t["seq"][0]),
                (torch.from_numpy(t["seq"][1][0]),)],
        "params": {"w": torch.from_numpy(t["params"]["w"]),
                   "b": torch.from_numpy(t["params"]["b"]).to(
                       torch.bfloat16)},
        "opt": {"m": torch.from_numpy(t["opt"]["m"]),
                "count": torch.tensor(t["opt"]["count"])},
    }


def _jax_tree(seed=0):
    t = _np_tree(seed)
    tree = jax.tree.map(jnp.asarray, t)
    tree["params"]["b"] = jnp.asarray(t["params"]["b"], jnp.bfloat16)
    return tree


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _leaves(tree, prefix=""):
    """name -> leaf, by the same naming both packages use."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def test_flatten_names_match_jax_paths():
    """Names are JAX's ``tree_flatten_with_path`` names, namedtuple fields
    and None subtrees included."""
    tree = {"z": [1.0, (2, 3)], "a": Pair(4, 5), "n": None,
            "m": {"y": 6, "x": 7}}
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    jnames = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path) for path, _ in jflat]
    named = _flatten_named(tree)
    assert list(named) == jnames
    assert all(isinstance(v, np.ndarray) for v in named.values())


def test_roundtrip_port(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _port_tree()
    mgr.save(5, tree, extra={"data": {"seed": 0, "step": 5}})
    target = {"opt": {"count": torch.tensor(0, dtype=torch.int32),
                      "m": torch.zeros(8, 16)},
              "params": {"b": torch.zeros(16, dtype=torch.bfloat16),
                         "w": torch.zeros(8, 16)},
              "seq": [torch.zeros(5, dtype=torch.int32),
                      (torch.zeros(3),)]}
    restored, step, extra = mgr.restore(target)
    assert step == 5 and extra["data"]["step"] == 5
    assert isinstance(restored["seq"][1], tuple)
    want, got = _leaves(tree), _leaves(restored)
    assert set(want) == set(got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(_bits(got[name]), _bits(want[name])), name
    manifest = (tmp_path / "step-5" / "manifest.json").read_text()
    assert '"dtype": "uint16"' in manifest      # bf16 stored as raw bits


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_package_roundtrip_bit_exact(tmp_path, writer):
    """A checkpoint written by either package restores in the other, bit
    for bit, bfloat16 included."""
    port_tree, jax_tree = _port_tree(3), _jax_tree(3)
    if writer == "port":
        CheckpointManager(tmp_path).save(2, port_tree, extra={"w": writer})
    else:
        JManager(tmp_path).save(2, jax_tree, extra={"w": writer})

    got_port, step_p, extra_p = CheckpointManager(tmp_path).restore(
        _port_tree(9))
    got_jax, step_j, extra_j = JManager(tmp_path).restore(
        jax.tree.map(jnp.zeros_like, jax_tree))
    assert step_p == step_j == 2 and extra_p == extra_j == {"w": writer}
    want = _leaves(port_tree)
    gp, gj = _leaves(got_port), _leaves(got_jax)
    assert set(gp) == set(gj) == set(want)
    for name in want:
        assert np.array_equal(_bits(gp[name]), _bits(want[name])), name
        assert np.array_equal(_bits(gj[name]), _bits(want[name])), name
    assert gp["params/b"].dtype == torch.bfloat16
    assert gj["params/b"].dtype == jnp.bfloat16

    named_p, _, _ = CheckpointManager(tmp_path).load_named()
    named_j, _, _ = JManager(tmp_path).load_named()
    assert set(named_p) == set(named_j)
    for k in named_p:
        assert named_p[k].dtype == named_j[k].dtype
        assert np.array_equal(named_p[k], named_j[k])


def test_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _port_tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert JManager(tmp_path).all_steps() == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken in ``save``: mutating the tensor while the
    writer thread runs does not reach the file."""
    mgr = CheckpointManager(tmp_path, keep=3)
    x = torch.arange(1000, dtype=torch.float32)
    mgr.save(1, {"x": x}, blocking=False)
    x.zero_()
    mgr.wait()
    assert mgr.all_steps() == [1]
    assert not list(tmp_path.glob("tmp-*"))
    got, _, _ = mgr.restore({"x": torch.empty(1000)})
    assert torch.equal(got["x"], torch.arange(1000, dtype=torch.float32))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_hash_mismatch_rejected(tmp_path, pkg):
    """A corrupted payload is refused by both packages' readers."""
    if pkg == "port":
        CheckpointManager(tmp_path).save(2, _port_tree())
    else:
        JManager(tmp_path).save(2, _jax_tree())
    payload = tmp_path / "step-2" / "arrays.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="hash mismatch"):
        CheckpointManager(tmp_path).restore(_port_tree())
    with pytest.raises(IOError, match="hash mismatch"):
        CheckpointManager(tmp_path).load_named()
    with pytest.raises(IOError, match="hash mismatch"):
        JManager(tmp_path).restore(_jax_tree())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shape_mismatch_rejected(tmp_path, pkg):
    if pkg == "port":
        CheckpointManager(tmp_path).save(1, {"w": torch.zeros(4, 4)})
    else:
        JManager(tmp_path).save(1, {"w": jnp.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(tmp_path).restore({"w": torch.zeros(8, 8)})
    with pytest.raises(ValueError, match="shape"):
        JManager(tmp_path).restore({"w": jnp.zeros((8, 8))})


def test_restore_places_leaves_and_refuses_shardings(tmp_path):
    """Each leaf lands on its target's device (or on ``device``); a None
    sharding leaf restores as no sharding does, and a shardings leaf that
    is not a (DeviceMesh, placements) pair is refused."""
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, tree)
    got, _, _ = mgr.restore({"w": torch.zeros(4, 4)}, device="cpu")
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"], tree["w"])
    plain, _, _ = mgr.restore(tree, shardings={"w": None})
    assert type(plain["w"]) is torch.Tensor
    assert torch.equal(plain["w"], tree["w"])
    with pytest.raises(ValueError, match="DeviceMesh"):
        mgr.restore(tree, shardings={"w": "data"})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(tree)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group (file store), destroyed afterwards."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("placement", ["shard0", "shard1", "replicate"])
def test_restore_onto_one_rank_mesh(tmp_path, one_rank_group, placement):
    """The elastic restart onto a one-rank CPU mesh: each sharded leaf is a
    DTensor whose full tensor is the stored array bit for bit, bfloat16
    included, as the reference restores onto its one-device mesh
    (tests/test_checkpoint.py's elastic case); an unsharded leaf stays a
    tensor."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro.parallel.compat import make_mesh
    from repro_torch.launch.mesh import make_flat_mesh
    tree = _port_tree(2)
    CheckpointManager(tmp_path).save(4, tree)
    pl, spec = {"shard0": (Shard(0), P("data", None)),
                "shard1": (Shard(1), P(None, "data")),
                "replicate": (Replicate(), P())}[placement]
    mesh = make_flat_mesh()
    got, step, _ = CheckpointManager(tmp_path).restore(
        tree, shardings={"params": {"w": (mesh, [pl]),
                                    "b": (mesh, [Shard(0)])},
                         "opt": {"m": (mesh, (pl,)), "count": None}})
    assert step == 4
    jmesh = make_mesh((1,), ("data",))
    rep = NamedSharding(jmesh, P())
    want, _, _ = JManager(tmp_path).restore(_jax_tree(2), shardings={
        "params": {"w": NamedSharding(jmesh, spec),
                   "b": NamedSharding(jmesh, P("data"))},
        "opt": {"m": NamedSharding(jmesh, spec), "count": rep},
        "seq": [rep, (rep,)]})
    for path in ("params/w", "params/b", "opt/m"):
        a, b = path.split("/")
        leaf = got[a][b]
        assert isinstance(leaf, DTensor), path
        assert leaf.placements[0] == (Shard(0) if b == "b" else pl)
        assert np.array_equal(_bits(leaf.full_tensor()),
                              _bits(want[a][b])), path
        assert np.array_equal(_bits(leaf.full_tensor()),
                              _bits(tree[a][b])), path
    assert not isinstance(got["opt"]["count"], DTensor)
    assert not isinstance(got["seq"][0], DTensor)
    assert np.array_equal(_bits(got["opt"]["count"]),
                          _bits(want["opt"]["count"]))


def test_restore_with_a_none_sharding_leaf(tmp_path, one_rank_group):
    """A None leaf in ``shardings`` leaves that leaf unsharded.  The
    reference pairs its flattened shardings with the target's leaves by
    position, and ``jax.tree.leaves`` drops the None, so a later leaf's
    sharding lands on an earlier leaf (here ``b``'s 2-D spec on the 1-D
    ``a``) and the restore raises; the port matches by name."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import DTensor, Shard

    from repro.parallel.compat import make_mesh
    from repro_torch.launch.mesh import make_flat_mesh
    JManager(tmp_path).save(1, {"a": jnp.arange(4.0),
                                "b": jnp.arange(6).reshape(2, 3)})
    jmesh = make_mesh((1,), ("data",))
    with pytest.raises(ValueError):
        JManager(tmp_path).restore(
            {"a": jnp.zeros(4), "b": jnp.zeros((2, 3), jnp.int32)},
            shardings={"a": None,
                       "b": NamedSharding(jmesh, P("data", None))})
    got, _, _ = CheckpointManager(tmp_path).restore(
        {"a": torch.zeros(4), "b": torch.zeros(2, 3, dtype=torch.int32)},
        shardings={"a": None, "b": (make_flat_mesh(), [Shard(0)])})
    assert not isinstance(got["a"], DTensor)
    assert torch.equal(got["a"], torch.arange(4.0))
    assert isinstance(got["b"], DTensor)
    assert torch.equal(got["b"].full_tensor(),
                       torch.arange(6, dtype=torch.int32).reshape(2, 3))
