"""PyTorch port, serving on a mesh: ``train.steps.make_prefill_step`` /
``make_decode_step`` on a ``DeviceMesh`` against the JAX package's sharded
serving steps.

Two subprocesses run side by side, each with its own deadline (the
pattern of ``tests/test_torch_train_sharded.py``):

  * the reference on 4 host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``): its prefill
    under the rules with the cache shardings ``make_prefill_step`` gives
    (its own step sizes the caches to the cell's ``seq_len``, 524,288
    rows under ``long_500k``), then ``make_decode_step`` on those caches;
  * the port on 4 gloo ranks (``launch.mesh.spawn_ranks``):
    ``make_prefill_step(..., s_max=S_MAX)`` and ``make_decode_step``, the
    parameters placed by ``shard_tree`` on the rules' shardings.

The cases cover the three cache layouts of ``parallel.rules.make_rules``
and every family: reduced ``yi-9b`` on (2, 2) (KV heads over ``model``,
layout (a)) and on (1, 4) (its 2 KV heads do not divide 4: ``head_dim``
over ``model``, layout (b)), there also with an int8 cache (each rank
rounds its head dims by the whole head's scale); ``qwen1.5-32b`` with its
int8 cache;
``starcoder2-15b`` with its window cut to WINDOW on both sides (the
reduced config keeps 4,096, which no reduced prompt reaches); under
``long_500k`` (batch 1, the cache's rows over ``data``, layout (c))
``jamba-v0.1-52b`` (a 32-row cache, 16 rows a data rank, a 12-token
prompt and 8 steps crossing into rank 1's rows) and ``rwkv6-7b`` (no KV
cache: its state with batch 1 and heads over ``model``); and
``qwen2-moe-a2.7b``, ``seamless-m4t-large-v2`` and ``internvl2-26b`` on
(2, 2).  The reference's weights (PRNGKey(1)) are carried over in
float32, except the encoder-decoder's, which stay in the config's bf16:
the reference's encoder scan cannot take float32 weights beside its bf16
frames.

Gates: the prefill's and every decode step's logits within TOL of the
reference's (``tests/test_torch_transformer.py``'s TOL, max abs
difference over max abs, real vocab), the greedy tokens equal, the
gathered caches equal to the reference's (int8 values equal, floats and
scales within TOL), every rank's logits and caches identical, and each
layout where its case says.
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

from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_from_specs as jinit  # noqa: E402
from repro_torch.models.convert import caches_from_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WINDOW = 8
# (case id, arch, mesh shape, cell, config overrides, batch)
CASES = (
    ("yi-9b-a", "yi-9b", (2, 2), "decode_32k", {}, 4),
    ("yi-9b-b", "yi-9b", (1, 4), "decode_32k", {}, 4),
    ("qwen1.5-32b-int8", "qwen1.5-32b", (2, 2), "decode_32k", {}, 4),
    ("starcoder2-15b-window", "starcoder2-15b", (2, 2), "decode_32k",
     {"window": WINDOW}, 4),
    ("jamba-v0.1-52b-sp", "jamba-v0.1-52b", (2, 2), "long_500k", {}, 1),
    ("rwkv6-7b-sp", "rwkv6-7b", (2, 2), "long_500k", {}, 1),
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", (2, 2), "decode_32k", {}, 4),
    ("seamless-m4t-large-v2", "seamless-m4t-large-v2", (2, 2), "decode_32k",
     {}, 4),
    ("internvl2-26b", "internvl2-26b", (2, 2), "decode_32k", {}, 4),
    ("yi-9b-b-int8", "yi-9b", (1, 4), "decode_32k",
     {"kv_cache_dtype": "int8"}, 4),
)
IDS = [c[0] for c in CASES]
PROMPT, STEPS, S_MAX, FRAMES = 12, 8, 32, 16
# each subprocess's deadline
TIMEOUT_S = 240
TOL = 0.02
# The stacked KV cache's placements per layout ((G, B, S, K, hd) on the
# (data, model) mesh).
LAYOUTS = {"yi-9b-a": "(Shard(dim=1), Shard(dim=3))",
           "yi-9b-b": "(Shard(dim=1), Shard(dim=4))",
           "yi-9b-b-int8": "(Shard(dim=1), Shard(dim=4))",
           "jamba-v0.1-52b-sp": "(Shard(dim=2), Shard(dim=3))"}

REF_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.models import transformer as T
    from repro.parallel.api import use_rules
    from repro.parallel.compat import make_mesh
    from repro.parallel.rules import cache_logical_axes
    from repro.train import steps as JS

    data = pickle.load(open(sys.argv[2], "rb"))
    out = {"devices": jax.device_count()}
    for cid, cfg, mshape, shape, inputs, weights, s_max, prompt in data:
        mesh = make_mesh(mshape, ("data", "model"))
        rules, psh, _, _ = JS.state_shardings(cfg, mesh, shape)
        params = jax.tree.map(jnp.asarray, weights)
        b = inputs["tokens"].shape[0]
        cax = cache_logical_axes(cfg, T.init_decode_caches(
            cfg, b, s_max, abstract=True))
        csh = jax.tree.map(lambda ax: rules.sharding(tuple(ax)), cax,
                           is_leaf=lambda x: isinstance(x, P))

        def pre(p, batch):
            with use_rules(rules):
                return T.prefill(cfg, p, batch, s_max)
        pre = jax.jit(pre, in_shardings=(psh, None),
                      out_shardings=(None, csh))
        dec, *_ = JS.make_decode_step(cfg, mesh, shape)
        toks = inputs["tokens"]
        extra = {k: jnp.asarray(v, jnp.bfloat16) for k, v in inputs.items()
                 if k != "tokens"}
        lg, caches = pre(params, {"tokens": jnp.asarray(toks[:, :prompt]),
                                  **extra})
        logits = [np.asarray(lg, np.float32)]
        for t in range(prompt, toks.shape[1]):
            lg, caches = dec(params, caches,
                             {"tokens": jnp.asarray(toks[:, t:t + 1])})
            logits.append(np.asarray(lg[:, 0], np.float32))
        out[cid] = {"logits": logits,
                    "caches": jax.tree.map(np.asarray, caches)}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

PORT_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import torch

    def rank_fn(rank, world, data):
        torch.set_num_threads(1)
        import dataclasses
        from repro_torch.configs import reduced_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import map_specs
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.parallel import make_mesh
        from repro_torch.train import steps as TS
        out = {"rank": rank}

        def leaf_types(tree):
            if isinstance(tree, dict):
                return set().union(*(leaf_types(v) for v in tree.values()))
            if isinstance(tree, tuple):
                return set().union(*(leaf_types(v) for v in tree))
            return {type(tree).__name__} if torch.is_tensor(tree) else set()

        # init_from_specs(..., shardings=): one whole leaf at a time, the
        # values and placements of shard_tree of the whole tree
        from repro_torch.models.common import init_from_specs
        from repro_torch.optim.adamw import tree_leaves
        cfg = reduced_config("qwen1.5-32b")
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        psh = TS.make_prefill_step(cfg, mesh, "decode_32k")[2]
        whole = TS.shard_tree(init_from_specs(T.model_specs(cfg), 5, "cpu"),
                              psh)
        leafwise = init_from_specs(T.model_specs(cfg), 5, "cpu",
                                   shardings=psh)
        out["sharded_init"] = all(
            torch.equal(a.to_local(), b.to_local())
            and a.placements == b.placements
            for a, b in zip(tree_leaves(whole), tree_leaves(leafwise)))

        for cid, arch, mshape, shape, over, f32, inputs, weights, s_max, \\
                prompt in data:
            cfg = reduced_config(arch)
            cfg = dataclasses.replace(cfg, **over)
            specs = T.model_specs(cfg)
            if f32:
                specs = map_specs(lambda s: dataclasses.replace(
                    s, dtype=torch.float32), specs)
            mesh = make_mesh(mshape, ("data", "model"), device_type="cpu")
            pre, rules, psh, csh = TS.make_prefill_step(cfg, mesh, shape,
                                                        s_max=s_max)
            dec, *_ = TS.make_decode_step(cfg, mesh, shape)
            params = TS.shard_tree(params_from_numpy(weights, specs, "cpu"),
                                   psh)
            toks = torch.from_numpy(inputs["tokens"])
            extra = {k: torch.from_numpy(v).to(torch.bfloat16)
                     for k, v in inputs.items() if k != "tokens"}
            lg, caches = pre(params, {"tokens": toks[:, :prompt], **extra})
            logits = [lg.float().numpy().copy()]
            for t in range(prompt, toks.shape[1]):
                lg, caches = dec(params, caches,
                                 {"tokens": toks[:, t:t + 1]})
                logits.append(lg[:, 0].float().numpy().copy())
            self_c = caches["self"] if "self" in caches else caches
            kv = [c for c in self_c.values() if hasattr(c, "length")]
            out[cid] = {
                "logits": logits,
                "caches": TS.gather_tree(caches),
                "kv_placements": str(tuple(kv[0].k.placements))
                if kv else None,
                "leaf_types": sorted(leaf_types(caches))}
        return out

    if __name__ == "__main__":
        from repro_torch.launch.mesh import spawn_ranks
        data = pickle.load(open(sys.argv[2], "rb"))
        res = spawn_ranks(rank_fn, 4, (data,), timeout=%d)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
""" % (TIMEOUT_S - 30))


def _config(arch, over):
    return dataclasses.replace(jreduced(arch), **over)


def _f32(arch) -> bool:
    """Float32 weights, except the encoder-decoder's (see the module
    doc)."""
    return _config(arch, {}).kind != "encdec"


def _inputs(cfg, batch: int, seed: int) -> dict:
    """Tokens (prompt and the teacher-forced steps), and the VLM's vision
    prefix or the encoder-decoder's frames as bf16 values in float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, PROMPT + STEPS))
           .astype(np.int32)}
    for key, n, on in (("vision_embeds", cfg.frontend_len,
                        cfg.family == "vlm"),
                       ("frames", FRAMES, cfg.kind == "encdec")):
        if on:
            out[key] = np.asarray(jnp.asarray(
                rng.normal(size=(batch, n, cfg.d_model)),
                jnp.bfloat16).astype(jnp.float32))
    return out


def _data():
    """(reference's, port's) per-case inputs, the same arrays."""
    ref, port = [], []
    for i, (cid, arch, mshape, shape, over, batch) in enumerate(CASES):
        cfg = _config(arch, over)
        params = jinit(JT.model_specs(cfg), jax.random.PRNGKey(1))
        if _f32(arch):
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        weights = jax.tree.map(np.asarray, params)
        inputs = _inputs(cfg, batch, 50 + i)
        ref.append((cid, cfg, mshape, shape, inputs, weights, S_MAX,
                    PROMPT))
        port.append((cid, arch, mshape, shape, over, _f32(arch), inputs,
                     weights, S_MAX, PROMPT))
    return ref, port


def _run_both(tmp: Path) -> tuple[dict, list]:
    ref_data, port_data = _data()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = {}
    for side, script, data in (("ref", REF_SCRIPT, ref_data),
                               ("port", PORT_SCRIPT, port_data)):
        with open(tmp / f"{side}_in.pkl", "wb") as f:
            pickle.dump(data, f)
        path = tmp / f"{side}_script.py"
        path.write_text(script)
        procs[side] = subprocess.Popen(
            [sys.executable, str(path), str(tmp / f"{side}.pkl"),
             str(tmp / f"{side}_in.pkl")], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
    return _run_both(tmp_path_factory.mktemp("serve_sharded"))


def _rel(want, got, vocab=None) -> float:
    want = np.asarray(want, np.float32)[..., :vocab]
    got = np.asarray(got, np.float32)[..., :vocab]
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


def _leaves(tree, prefix=""):
    """(name, leaf) of a cache tree, named tuples by field; a KV cache's
    length is a leaf too."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}.{f}")
    else:
        yield prefix, tree


def test_four_devices_and_ranks(runs):
    ref, port = runs
    assert ref["devices"] == 4
    assert [r["rank"] for r in port] == [0, 1, 2, 3]


@pytest.mark.parametrize("cid", IDS)
def test_logits_match_reference(runs, cid):
    ref, port = runs
    arch = next(c[1] for c in CASES if c[0] == cid)
    vocab = jreduced(arch).vocab
    want, got = ref[cid]["logits"], port[0][cid]["logits"]
    assert len(want) == len(got) == 1 + STEPS
    for step, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, step
        assert _rel(w, g, vocab) < TOL, (step, _rel(w, g, vocab))


@pytest.mark.parametrize("cid", IDS)
def test_greedy_tokens_match_reference(runs, cid):
    ref, port = runs
    arch = next(c[1] for c in CASES if c[0] == cid)
    vocab = jreduced(arch).vocab
    for w, g in zip(ref[cid]["logits"], port[0][cid]["logits"]):
        np.testing.assert_array_equal(np.argmax(w[..., :vocab], -1),
                                      np.argmax(g[..., :vocab], -1))


@pytest.mark.parametrize("cid", IDS)
def test_gathered_caches_match_reference(runs, cid):
    """The caches after the last step, gathered whole: int8 values equal,
    every other array within TOL, every length equal."""
    ref, port = runs
    want = dict(_leaves(caches_from_numpy(ref[cid]["caches"], "cpu")))
    got = dict(_leaves(port[0][cid]["caches"]))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if w is None or isinstance(w, int):
            assert g == w, name
            continue
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype, name
        if w.dtype == torch.int8:
            assert torch.equal(g, w), (name, int((g != w).sum()))
        else:
            assert _rel(w.float().numpy(), g.float().numpy()) < TOL, name


@pytest.mark.parametrize("cid", IDS)
def test_every_rank_identical(runs, cid):
    _, port = runs
    first = port[0][cid]
    for r in port[1:]:
        for a, b in zip(first["logits"], r[cid]["logits"]):
            np.testing.assert_array_equal(a, b)
        for (na, a), (nb, b) in zip(_leaves(first["caches"]),
                                    _leaves(r[cid]["caches"])):
            assert na == nb
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), na
            else:
                assert a == b, na


@pytest.mark.parametrize("cid", sorted(LAYOUTS))
def test_cache_layouts(runs, cid):
    """Layout (a): batch over data, KV heads over model; (b): head_dim
    over model; (c): the rows over data.  The caches stay DTensors."""
    _, port = runs
    for r in port:
        assert r[cid]["kv_placements"] == LAYOUTS[cid]
        assert r[cid]["leaf_types"] == ["DTensor"]


def test_sharded_init_equals_shard_tree(runs):
    """``init_from_specs(..., shardings=psh)`` makes each rank's shards of
    the same values, on the same placements, as ``shard_tree`` of the
    whole tree."""
    _, port = runs
    assert all(r["sharded_init"] for r in port)
