"""PyTorch port, ``parallel/`` and what runs through it: the sharding
rules against the JAX package's ``repro.parallel.rules``, attention on
each rank's own heads, the MoE dispatch per data shard, and
``optim.compress.make_ef_int8_pod_reduce``.

  * Rules: for every arch x each of its supported shapes x the abstract
    meshes (2, 2) (``data``, ``model``) and (2, 2, 2) (``pod``, ``data``,
    ``model``), the port's mapping and its physical spec of every
    parameter's logical axes, of every ZeRO-1 state and of every decode
    cache equal the reference's exactly.
  * MoE: ``moe_apply`` under rules whose ``batch`` spans two data shards,
    against the reference's at the same dp (its ``shard_hint`` made the
    identity: the layout hints need devices, the values do not): the kept
    slots identical, the outputs within float32 1e-5.
  * Local heads and the pod reduce run in one subprocess of 4 gloo ranks
    (``launch.mesh.spawn_ranks``): attention on DTensors sharded by head
    over a 4-way ``model`` dimension, the KV heads split with them or
    left replicated (a rank then reads part of one group, or KV heads of
    two groups), against the unsharded attention, gradients included;
    the int8 pod reduce on (pod 2, data 2), bit-equal to the reference's
    on 4 host devices (a second subprocess, side by side); the loss's
    vocab-sharded cross-entropy on (2, 2) and (1, 4) meshes against
    ``jax.nn.logsumexp`` and its ``jax.grad``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import ARCHS, get_config, supported_shapes  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import abstract_from_specs as jabstract  # noqa: E402
from repro.models.common import logical_axes as jlogical  # noqa: E402
from repro.parallel import rules as JR  # noqa: E402
from repro.parallel.api import MeshRules as JMeshRules  # noqa: E402
from repro.parallel.api import use_rules as juse_rules  # noqa: E402
from repro.parallel.compat import abstract_mesh as jabstract_mesh  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    abstract_from_specs,
    leaf_paths,
    logical_axes,
)
from repro_torch.parallel import (  # noqa: E402
    MeshRules,
    abstract_mesh,
    cache_logical_axes,
    make_rules,
    param_shardings,
    use_rules,
    zero1_shardings,
)
from test_torch_moe import port as moe_case  # noqa: E402
from test_torch_moe import rel  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RULE_CASES = [(arch, shape, m) for arch in sorted(ARCHS)
              for shape in supported_shapes(get_config(arch))
              for m in MESHES]
TIMEOUT_S = 180


# ------------------------------------------------------------- rules ----
def _jax_cache_axes(cfg, batch, s_max):
    """path -> tuple of the reference's cache logical axes, of its arrays
    the port also holds (a ``KVCache``'s length is a host int there)."""
    caches = JT.init_decode_caches(cfg, batch=batch, s_max=s_max,
                                   abstract=True)
    cax = JR.cache_logical_axes(cfg, caches)
    shapes, _ = jax.tree_util.tree_flatten_with_path(caches)
    axes = jax.tree.leaves(cax, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), ax in zip(shapes, axes):
        key = _jkey(path)
        if len(leaf.shape) and not key.endswith("/length"):
            out[key] = tuple(ax)
    return out


def _jkey(path) -> str:
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(str(k.idx))
    return "/".join(parts)


def _torch_cache_axes(cfg, batch, s_max):
    caches = TT.init_decode_caches(cfg, batch, s_max, abstract=True)
    cax = cache_logical_axes(cfg, caches)
    out = {}

    def walk(c, a, prefix):
        if isinstance(c, torch.Tensor):
            if c.dim():
                out["/".join(prefix)] = a
        elif isinstance(c, dict):
            for k in c:
                walk(c[k], a[k], prefix + (k,))
        elif isinstance(c, tuple) and hasattr(type(c), "_fields"):
            for f in c._fields:
                walk(getattr(c, f), getattr(a, f), prefix + (f,))
    walk(caches, cax, ())
    return out


@pytest.mark.parametrize("arch,shape,mesh", RULE_CASES)
def test_rules_match_reference(arch, shape, mesh):
    """Mapping, parameter specs, ZeRO-1 specs and cache axes, exactly."""
    dims, axes = MESHES[mesh]
    jcfg, tcfg = get_config(arch), tget_config(arch)
    jr = JR.make_rules(jabstract_mesh(dims, axes), jcfg, shape)
    tr = make_rules(abstract_mesh(dims, axes), tcfg, shape)
    assert tr.mapping == jr.mapping
    jspecs, tspecs = JT.model_specs(jcfg), TT.model_specs(tcfg)
    jax_axes = jax.tree.leaves(jlogical(jspecs),
                               is_leaf=lambda x: isinstance(x, tuple))
    paths = leaf_paths(tspecs)
    assert [s.axes for _, s in paths] == [tuple(a) for a in jax_axes]
    # every parameter's physical spec
    psh = leaf_paths_of(param_shardings(tr, logical_axes(tspecs)))
    assert [sh.spec for _, sh in psh] == [tuple(jr.spec(tuple(ax)))
                                          for ax in jax_axes]
    # ZeRO-1: the data axes on the first dim that takes them
    jz = jax.tree.leaves(
        JR.zero1_shardings(jr, jlogical(jspecs), jabstract(jspecs)),
        is_leaf=lambda x: hasattr(x, "spec"))
    tz = leaf_paths_of(zero1_shardings(tr, logical_axes(tspecs),
                                       abstract_from_specs(tspecs)))
    assert [sh.spec for _, sh in tz] == [tuple(z.spec) for z in jz]
    # decode caches
    want = _jax_cache_axes(jcfg, 8, 64)
    got = _torch_cache_axes(tcfg, 8, 64)
    assert got == want
    for ax in got.values():
        assert tuple(tr.spec(ax)) == tuple(jr.spec(ax))


def leaf_paths_of(tree, prefix=()):
    """(path, leaf) of a nested dict's leaves in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths_of(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 8)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serving_param_shardings_keep_head_dim_whole(arch, mesh):
    """A serving step's parameters take the rules' shardings with
    ``head_dim`` whole: the reference's spec of every leaf, less the mesh
    axis of its ``head_dim`` where the rules split that (the KV heads do
    not divide ``model``: yi-9b and starcoder2-15b on (1, 8)); the cache
    keeps the split."""
    from repro_torch.parallel.rules import serving_param_shardings
    cfg = tget_config(arch)
    rules = make_rules(abstract_mesh(mesh, ("data", "model")), cfg,
                       "decode_32k")
    specs = TT.model_specs(cfg)
    axes = dict(leaf_paths(specs))
    want = leaf_paths_of(param_shardings(rules, logical_axes(specs)))
    got = leaf_paths_of(serving_param_shardings(rules, logical_axes(specs)))
    assert [p for p, _ in got] == [p for p, _ in want]
    changed = 0
    for (path, w), (_, g) in zip(want, got):
        logical = axes[path].axes
        spec = list(w.spec) + [None] * (len(logical) - len(w.spec))
        spec = [None if ax == "head_dim" else x
                for x, ax in zip(spec, logical)]
        while spec and spec[-1] is None:
            spec.pop()
        assert g.spec == tuple(spec), path
        changed += g.spec != w.spec
    split = rules.mapping["head_dim"] is not None
    assert split == (cfg.n_kv_padded % mesh[1] != 0)
    assert (changed > 0) == split
    if split:
        assert rules.spec(("layers", "batch", "seq_kv", "kv_heads",
                           "head_dim"))[-1] == "model"


def test_rules_without_devices_and_their_placements():
    """The abstract mesh needs no process group; a spec's placements are
    Shard on the dims that name a mesh axis, Replicate elsewhere, a dim
    over two axes sharded by both."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.api import placements
    mesh = abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert placements(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(mesh, ()) == [Replicate()] * 3
    rules = MeshRules(mesh, {"a": "model", "b": "model", "c": ("pod",)})
    assert rules.spec(("a", "b", None)) == ("model",)
    assert rules.spec(("c", None, "a")) == ("pod", None, "model")
    assert rules.spec((None, None)) == ()


def test_shard_hint_is_the_identity_without_a_dtensor():
    from repro_torch.parallel import shard_hint
    x = torch.ones(4, 3)
    assert shard_hint(x, "batch", "embed") is x
    with use_rules(make_rules(abstract_mesh((2, 2), ("data", "model")),
                              tget_config("yi-9b"), "train_4k")):
        assert shard_hint(x, "batch", "embed") is x


# --------------------------------------------------------------- MoE ----
def _ref_dispatch_dp(jp, x, dp, *, n_experts, n_experts_padded, top_k,
                     capacity_factor):
    """The reference's shard-local routing and dispatch, line for line
    (src/repro/models/moe.py, ``moe_apply`` at dp shards): (slot, keep),
    each (dp, T / dp * k)."""
    t, d = x.shape[0] * x.shape[1], x.shape[2]
    e = n_experts_padded
    t_loc = t // dp
    ll = t_loc * top_k
    logits = jnp.einsum("td,de->te", x.reshape(t, d).astype(jnp.float32),
                        jp["router"])
    if n_experts < e:
        logits = jnp.where((jnp.arange(e) >= n_experts)[None, :], -1e30,
                           logits)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    cap = int(max(8, -(-t_loc * top_k * capacity_factor // e)))
    flat_e = expert_idx.reshape(dp, ll).astype(jnp.int32)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    run_start = jax.vmap(
        lambda row: jnp.searchsorted(row, row, side="left"))(sorted_e)
    pos = jnp.arange(ll, dtype=jnp.int32)[None, :] - run_start
    keep = pos < cap
    slot = jnp.where(keep, sorted_e * cap + pos, e * cap)
    return np.asarray(slot), np.asarray(keep)


MOE_CASES = ("drops", "padded", "top4")


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_dispatch_per_data_shard_matches_reference(name, monkeypatch):
    jp, tp, jx, tx, kw = moe_case(name, "float32")
    dp = 2
    monkeypatch.setattr(jmoe, "shard_hint", lambda x, *a: x)
    jrules = JMeshRules(mesh=jabstract_mesh((dp, 1), ("data", "model")),
                        mapping={"batch": ("data",), "expert": "model"})
    with juse_rules(jrules):
        assert jmoe._data_shards() == dp
        want = jmoe.moe_apply(jp, jx, **kw)
    trules = MeshRules(mesh=abstract_mesh((dp, 1), ("data", "model")),
                       mapping={"batch": ("data",), "expert": "model"})
    with use_rules(trules):
        assert tmoe._data_shards() == dp
        got = tmoe.moe_apply(tp, tx, **kw)
    assert rel(want, got) < 1e-5
    # the kept slots, shard by shard
    want_slot, want_keep = _ref_dispatch_dp(jp, jx, dp, **kw)
    t = tx.shape[0] * tx.shape[1]
    _, idx = tmoe.moe_route(tp, tx.reshape(t, -1), n_experts=kw["n_experts"],
                            top_k=kw["top_k"])
    cap = tmoe.capacity(t // dp, kw["top_k"], kw["n_experts_padded"],
                        kw["capacity_factor"])
    _, slot, keep = tmoe.moe_dispatch(idx.reshape(dp, t // dp, -1),
                                      kw["n_experts_padded"], cap)
    assert np.array_equal(keep.numpy(), want_keep)
    assert np.array_equal(slot.numpy(), want_slot)
    # shard-local capacity keeps other tokens than one global sort
    with use_rules(None):
        one = tmoe.moe_apply(tp, tx, **kw)
    if name == "drops":
        assert rel(one, got) > 1e-3


def test_moe_dp_falls_back_to_one_shard_when_tokens_do_not_divide():
    jp, tp, jx, tx, kw = moe_case("padded", "float32")   # T = 80
    trules = MeshRules(mesh=abstract_mesh((3, 1), ("data", "model")),
                       mapping={"batch": ("data",)})
    with use_rules(trules):
        got = tmoe.moe_apply(tp, tx, **kw)
    assert torch.equal(got, tmoe.moe_apply(tp, tx, **kw))


# ------------------------------------- local heads and the pod reduce ----
GQA = {"part_of_a_group": (4, 2, 16), "two_groups": (24, 3, 8),
       "split": (8, 4, 16)}
POD_DTYPES = ("float32", "bfloat16")
# (mesh shape over (data, model), vocab): the vocab split evenly, unevenly
# (torch.chunk's ceil(V / n) rows a shard), and four ways
XENT = {"vocab_split": ((2, 2), 20), "uneven_vocab": ((2, 2), 21),
        "four_way_vocab": ((1, 4), 22)}

COMMON = textwrap.dedent("""
    import pickle, sys
    import numpy as np

    GQA, POD_DTYPES, XENT = %r, %r, %r

    def xent_inputs(vocab):
        rng = np.random.default_rng(90 + vocab)
        logits = (rng.standard_normal((8, 6, vocab)) * 3).astype(np.float32)
        return logits, rng.integers(0, vocab, (8, 6)).astype(np.int64)

    def pod_inputs(pod):
        rng = np.random.default_rng(70 + pod)
        g = (rng.standard_normal((64, 33)) * (1 + pod)).astype(np.float32)
        err = (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32)
        return g, err
""" % (GQA, POD_DTYPES, XENT))

REF_SCRIPT = COMMON + textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    from repro.optim.compress import make_ef_int8_pod_reduce
    from repro.parallel.compat import make_mesh

    mesh = make_mesh((2, 2), ("pod", "data"))
    fn = make_ef_int8_pod_reduce(mesh)
    out = {"devices": jax.device_count()}
    for dt in POD_DTYPES:
        dtype = getattr(jnp, dt)
        def arr(i):
            shards = []
            for dev in mesh.devices.flat:
                pod = int(np.argwhere(mesh.devices == dev)[0][0])
                a = jnp.asarray(pod_inputs(pod)[i])
                shards.append(jax.device_put(
                    a.astype(dtype) if i == 0 else a, dev))
            return jax.make_array_from_single_device_arrays(
                shards[0].shape, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec()), shards)
        mean, err = fn(arr(0), arr(1))
        out[dt] = {
            "mean": [np.asarray(s.data.astype(jnp.float32))
                     for s in mean.addressable_shards],
            "err": [np.asarray(s.data) for s in err.addressable_shards],
            "pods": [int(np.argwhere(mesh.devices == s.device)[0][0])
                     for s in err.addressable_shards]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

PORT_SCRIPT = COMMON + textwrap.dedent("""
    import torch

    def gqa(mesh, h, k, hd):
        from torch.distributed.tensor import Replicate, Shard, \\
            distribute_tensor
        from repro_torch.models import attention as attn
        rng = np.random.default_rng(h * 100 + k)
        q, kk, v, w = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((2, 8, h, hd), (2, 8, k, hd),
                                   (2, 8, k, hd), (2, 8, h, hd)))
        pos = torch.arange(8, dtype=torch.int32)
        leaves = [t.clone().requires_grad_(True) for t in (q, kk, v)]
        want = attn._self_attention(*leaves, pos, causal=True, chunk=4,
                                    window=None)
        (want * w).sum().backward()
        tp = mesh.size(1)
        kv_pl = [Replicate(), Shard(2) if k %% tp == 0 else Replicate()]
        dq = distribute_tensor(q, mesh, [Replicate(), Shard(2)],
                               src_data_rank=None).requires_grad_(True)
        dk, dv = (distribute_tensor(t, mesh, kv_pl, src_data_rank=None
                                    ).requires_grad_(True) for t in (kk, v))
        got = attn._self_attention(dq, dk, dv, pos, causal=True, chunk=4,
                                   window=None)
        rep = [Replicate(), Replicate()]
        (got.redistribute(placements=rep).to_local(grad_placements=rep)
         * w).sum().backward()
        return {"out": (got.full_tensor().detach().numpy(),
                        want.detach().numpy()),
                "placements": str(got.placements),
                "grads": [(d.grad.full_tensor().numpy(), t.grad.numpy())
                          for d, t in zip((dq, dk, dv), leaves)]}

    def xent(shape, vocab):
        from torch.distributed.tensor import Replicate, Shard, \\
            distribute_tensor
        from repro_torch.models import transformer as T
        from repro_torch.parallel import make_mesh
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        lg, tg = (torch.from_numpy(a) for a in xent_inputs(vocab))
        lg = distribute_tensor(lg, mesh, [Shard(0), Shard(2)],
                               src_data_rank=None).requires_grad_(True)
        tg = distribute_tensor(tg, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        loss = T._mean_xent(lg, tg)
        loss.backward()
        return {"loss": float(loss), "grad": lg.grad.full_tensor().numpy(),
                "grad_placements": str(lg.grad.placements)}

    def rank_fn(rank, world):
        torch.set_num_threads(1)
        from repro_torch.optim.compress import make_ef_int8_pod_reduce
        from repro_torch.parallel import make_mesh
        out = {"rank": rank}
        for name, (shape, vocab) in XENT.items():
            out[name] = xent(shape, vocab)
        heads = make_mesh((1, 4), ("data", "model"), device_type="cpu")
        for name, (h, k, hd) in GQA.items():
            out[name] = gqa(heads, h, k, hd)
        mesh = make_mesh((2, 2), ("pod", "data"), device_type="cpu")
        fn = make_ef_int8_pod_reduce(mesh)
        pod = mesh.get_local_rank("pod")
        g, err = (torch.from_numpy(a) for a in pod_inputs(pod))
        for dt in POD_DTYPES:
            mean, new_err = fn(g.to(getattr(torch, dt)), err)
            out[dt] = {"mean": mean.float().numpy(),
                       "err": new_err.numpy(), "pod": pod,
                       "dtype": str(mean.dtype)}
        return out

    if __name__ == "__main__":
        from repro_torch.launch.mesh import spawn_ranks
        res = spawn_ranks(rank_fn, 4, (), timeout=%d)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
""" % (TIMEOUT_S - 30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = {}
    for side, script in (("ref", REF_SCRIPT), ("port", PORT_SCRIPT)):
        path = tmp / f"{side}_script.py"
        path.write_text(script)
        procs[side] = subprocess.Popen(
            [sys.executable, str(path), str(tmp / f"{side}.pkl")], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
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


@pytest.mark.parametrize("name", sorted(GQA))
def test_attention_on_local_heads_matches_unsharded(runs, name):
    """Each rank's heads against the unsharded attention (the plain
    version on the CPU: per head the same sums), output and gradients."""
    _, port = runs
    for r in port:
        got, want = r[name]["out"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert "Shard(dim=2)" in r[name]["placements"]
        for g, w in r[name]["grads"]:
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dt", POD_DTYPES)
def test_ef_int8_pod_reduce_bit_equal_to_reference(runs, dt):
    ref, port = runs
    assert ref["devices"] == 4
    want = ref[dt]
    for m in want["mean"][1:]:
        np.testing.assert_array_equal(m, want["mean"][0])
    for r in port:
        assert r[dt]["dtype"] == f"torch.{dt}"
        np.testing.assert_array_equal(r[dt]["mean"], want["mean"][0])
        err = want["err"][want["pods"].index(r[dt]["pod"])]
        np.testing.assert_array_equal(r[dt]["err"], err)
    # the pods' gradients differ, so the mean is no pod's own
    assert {r[dt]["pod"] for r in port} == {0, 1}


@pytest.mark.parametrize("name", sorted(XENT))
def test_sharded_cross_entropy_matches_reference(runs, name):
    """The train loss's tail on vocab-sharded DTensor logits (each rank's
    max, sum of exponentials and gold logit all-reduced over the vocab's
    shards) against the reference's mean of ``logsumexp - gold``, value
    and gradient, float32; every rank the same."""
    _, port = runs
    _, vocab = XENT[name]
    ns = {}
    exec(COMMON, ns)
    lg, tg = ns["xent_inputs"](vocab)

    def ref_loss(x):
        gold = jnp.take_along_axis(x, jnp.asarray(tg)[..., None], -1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(x, axis=-1) - gold)
    want, wgrad = jax.value_and_grad(ref_loss)(jnp.asarray(lg))
    wgrad = np.asarray(wgrad)
    for r in port:
        got = r[name]
        np.testing.assert_allclose(got["loss"], float(want), rtol=1e-5)
        assert got["grad_placements"] == "(Shard(dim=0), Shard(dim=2))"
        np.testing.assert_allclose(got["grad"], wgrad, rtol=0,
                                   atol=1e-5 * np.abs(wgrad).max())


def test_pod_reduce_needs_a_pod_axis():
    from repro_torch.optim.compress import make_ef_int8_pod_reduce

    class Mesh:
        mesh_dim_names = ("data", "model")
    with pytest.raises(AssertionError):
        make_ef_int8_pod_reduce(Mesh())


def test_train_step_builders_name_their_shardings():
    """``state_shardings`` on an abstract mesh: parameter shardings per
    the rules, ZeRO-1 for the moments, the count replicated."""
    from repro_torch.train.steps import state_shardings
    cfg = tget_config("yi-9b")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    rules, psh, osh, abstract = state_shardings(cfg, mesh, "train_4k")
    assert psh["embed"]["table"].spec == ("model",)
    assert osh.m["embed"]["table"].spec == (("model", "data"),)
    assert osh.m["final_norm"]["scale"].spec == ("data",)
    assert osh.count.spec == ()
    assert abstract["embed"]["table"].device.type == "meta"
    assert dataclasses.is_dataclass(rules)
