"""PyTorch port, the transformer of every family and LM serving against
the JAX package.

For the ten archs at ``reduced_config`` (the dense decoders ``yi-9b``,
``mistral-nemo-12b``, ``starcoder2-15b`` with its sliding window, layer
norm, GELU MLP and qkv bias, ``qwen1.5-32b`` with qkv bias and the int8
KV cache, also with padded heads; the MoE ``qwen2-moe-a2.7b`` with its
shared expert and ``arctic-480b`` with its dense residual; the hybrid
``jamba-v0.1-52b``, Mamba + attention + MoE in a period of 8; ``rwkv6-7b``;
the encoder-decoder ``seamless-m4t-large-v2`` with its frames; the VLM
``internvl2-26b`` with its vision prefix), the reference's weights
(``init_from_specs(..., PRNGKey)``) are carried over with
``params_from_numpy``, and ``forward_train``, ``prefill`` and
``decode_step`` logits are held to the reference's at 0.02 relative (max
abs difference over max abs, over the real vocab): the models run in bf16,
and the two frameworks round other partial sums to bf16
(``tests/test_serving.py``'s TOL).  The port's own decode is held to its
own forward the same way, step by step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_from_specs as jinit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.engine.config import UNPORTED  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    float32_replay,
    init_from_specs,
)
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 0.02
DENSE = ("yi-9b", "mistral-nemo-12b", "starcoder2-15b", "qwen1.5-32b",
         "qwen1.5-32b+padded")
OTHER = ("jamba-v0.1-52b", "rwkv6-7b", "seamless-m4t-large-v2",
         "arctic-480b", "qwen2-moe-a2.7b", "internvl2-26b")
ALL = DENSE + OTHER


def configs(name):
    """(reference, port) reduced configs; ``+padded``: 20 heads, padded to
    32 (configs/base.py ``n_heads_padded``), head dim 16."""
    arch, _, variant = name.partition("+")
    j, t = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    if variant == "padded":
        kw = dict(n_heads=20, n_kv=20, head_dim=16)
        j, t = dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)
        assert t.n_heads_padded == 32
    return j, t


_MODELS = {}


def model(name):
    """(jcfg, tcfg, jax params, port params), the port's carried over."""
    if name not in _MODELS:
        jcfg, tcfg = configs(name)
        jp = jinit(JT.model_specs(jcfg), jax.random.PRNGKey(1))
        tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
        tp = params_from_numpy(tree, TT.model_specs(tcfg), "cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def rel(want, got, vocab):
    a = np.asarray(jnp.asarray(want).astype(jnp.float32))[..., :vocab] \
        if not isinstance(want, torch.Tensor) \
        else want.float().numpy()[..., :vocab]
    b = got.float().numpy()[..., :vocab]
    assert a.shape == b.shape
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def extras(cfg, b, seed):
    """The VLM's vision prefix and the encoder-decoder's frames (16 of
    them), normal draws in bf16 as ``tests/test_serving.py`` makes them:
    (reference's, port's) dicts, empty for the other families."""
    rng = np.random.default_rng(seed + 100)
    j, t = {}, {}
    for key, n, on in (("vision_embeds", cfg.frontend_len,
                        cfg.family == "vlm"),
                       ("frames", 16, cfg.kind == "encdec")):
        if on:
            a = np.array(jnp.asarray(rng.normal(size=(b, n, cfg.d_model)),
                                     jnp.bfloat16).astype(jnp.float32))
            j[key] = jnp.asarray(a, jnp.bfloat16)
            t[key] = torch.from_numpy(a).to(torch.bfloat16)
    return j, t


def offset(cfg):
    """Positions before the first token: the VLM's prefix."""
    return cfg.frontend_len if cfg.family == "vlm" else 0


def self_caches(c, cfg):
    return c["self"] if cfg.kind == "encdec" else c


@pytest.mark.parametrize("name", ALL)
def test_forward_train_matches_reference(name):
    jcfg, tcfg, jp, tp = model(name)
    toks = tokens(tcfg, 2, 24, 2)
    jx, tx = extras(tcfg, 2, 2)
    want = JT.forward_train(jcfg, jp, {"tokens": jnp.asarray(toks), **jx})
    with torch.inference_mode():
        got = TT.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                          **tx})
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, offset(tcfg) + 24, tcfg.vocab_padded)
    assert rel(want, got, tcfg.vocab) < TOL


def check_states(jc, tc, cfg, length):
    """The port's prefill caches against the reference's: KV caches of
    the reference's shape and dtype, ``length`` rows filled (zeros
    past them); the Mamba / RWKV states and the memory K / V within
    TOL."""
    jself, tself = self_caches(jc, cfg), self_caches(tc, cfg)
    assert sorted(jself) == sorted(tself)
    for pos, c in tself.items():
        if isinstance(c, tuple) and hasattr(c, "length"):
            assert c.length == length
            assert c.k.shape == jself[pos].k.shape and c.k.dtype == (
                torch.int8 if cfg.kv_cache_dtype == "int8"
                else torch.bfloat16)
            assert not torch.any(c.k[:, :, length:])
            continue
        for f, jf, tf in zip(c._fields, jself[pos], c):
            assert tuple(tf.shape) == jf.shape, f
            assert str(tf.dtype).replace("torch.", "") \
                == jnp.dtype(jf.dtype).name, f
            assert rel(jf, tf, None) < TOL, f
    if cfg.kind == "encdec":
        for f in ("memory_k", "memory_v"):
            assert tuple(tc[f].shape) == jc[f].shape
            assert rel(jc[f], tc[f], None) < TOL


@pytest.mark.parametrize("name", ALL)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits, its caches, and two decode steps' logits."""
    jcfg, tcfg, jp, tp = model(name)
    toks = tokens(tcfg, 2, 22, 3)
    jx, tx = extras(tcfg, 2, 3)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :20]),
                                   **jx}, s_max=64)
    with torch.inference_mode():
        tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(
            toks[:, :20]), **tx}, s_max=64)
    assert tl.shape == (2, tcfg.vocab_padded)
    assert rel(jl, tl, tcfg.vocab) < TOL
    check_states(jc, tc, tcfg, offset(tcfg) + 20)
    for t in (20, 21):
        jd, jc = JT.decode_step(jcfg, jp, jc,
                                {"tokens": jnp.asarray(toks[:, t:t + 1])})
        with torch.inference_mode():
            td, tc = TT.decode_step(tcfg, tp, tc, {
                "tokens": torch.from_numpy(toks[:, t:t + 1])})
        assert td.shape == (2, 1, tcfg.vocab_padded)
        assert rel(jd, td, tcfg.vocab) < TOL, t
    check_states(jc, tc, tcfg, offset(tcfg) + 22)


@pytest.mark.parametrize("name", ALL)
def test_multi_step_decode_matches_own_forward(name):
    """Decoding tokens one by one == the train forward over the whole
    sequence (tests/test_serving.py:54)."""
    _, cfg, _, params = model(name)
    s_pre, n_dec = 8, 6
    toks = torch.from_numpy(tokens(cfg, 1, s_pre + n_dec, 4))
    _, tx = extras(cfg, 1, 4)
    o = offset(cfg)
    with torch.inference_mode():
        full = TT.forward_train(cfg, params, {"tokens": toks, **tx})
        _, caches = TT.prefill(cfg, params, {"tokens": toks[:, :s_pre],
                                             **tx}, s_max=64)
        for t in range(n_dec):
            dec, caches = TT.decode_step(cfg, params, caches, {
                "tokens": toks[:, s_pre + t:s_pre + t + 1]})
            assert rel(full[:, o + s_pre + t], dec[:, -1], cfg.vocab) \
                < TOL, t


@pytest.mark.parametrize("name", ALL[:4] + OTHER)
def test_init_decode_caches_match_reference(name):
    """The reference's abstract cache tree, leaf for leaf: shapes and
    dtypes on ``meta`` (a KV cache's length is a host int, 0)."""
    jcfg, tcfg = configs(name)
    jc = JT.init_decode_caches(jcfg, 3, 40, abstract=True)
    tc = TT.init_decode_caches(tcfg, 3, 40, abstract=True)
    assert sorted(jc) == sorted(tc)
    jself, tself = self_caches(jc, tcfg), self_caches(tc, tcfg)
    assert sorted(jself) == sorted(tself)
    pairs = []
    for pos in jself:
        assert type(jself[pos]).__name__ == type(tself[pos]).__name__
        for f in jself[pos]._fields:
            j, t = getattr(jself[pos], f), getattr(tself[pos], f)
            if f == "length":
                assert t == 0
                continue
            assert (j is None) == (t is None), f
            if j is not None:
                pairs.append((j, t))
    if tcfg.kind == "encdec":
        pairs += [(jc[f], tc[f]) for f in ("memory_k", "memory_v")]
    for j, t in pairs:
        assert tuple(t.shape) == j.shape and t.device.type == "meta"
        assert str(t.dtype).replace("torch.", "") \
            == jnp.dtype(j.dtype).name


def test_unported_names_each_roadmap_item():
    """Every family is ported, serves and trains on one device or a mesh,
    under a window too: what stays unported is B5's (Queue B), on CUDA
    only: head dims other than 64 and 128."""
    assert set(UNPORTED) == {
        "attention head dims other than 64 and 128 on CUDA"}
    for k, item in UNPORTED.items():
        assert "A15.3" not in item and "Queue B" in item \
            and "CUDA" in k, k


def test_serve_runs_on_cpu_and_is_greedy():
    """serve() with the port's weights: the generated tokens are the
    greedy replay of prefill and decode_step."""
    out = tserve.serve("starcoder2-15b", batch=2, prompt_len=10, max_new=5,
                       s_max=32, seed=2, device="cpu")
    gen = out["generated"]
    assert gen.shape == (2, 5) and gen.dtype == np.int32
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    cfg = tconfigs.reduced_config("starcoder2-15b")
    params = init_from_specs(TT.model_specs(cfg), 2, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 10)).astype(np.int32))
    with torch.inference_mode():
        lg, caches = TT.prefill(cfg, params, {"tokens": prompts}, 32)
        want = [lg.argmax(-1)]
        for _ in range(4):
            lg, caches = TT.decode_step(cfg, params, caches, {
                "tokens": want[-1][:, None].int()})
            want.append(lg[:, -1].argmax(-1))
    assert np.array_equal(torch.stack(want, 1).numpy(), gen)
    assert (gen < cfg.vocab).all()


def test_serve_with_reference_weights_matches_reference_prefill():
    """The first generated token of each prompt is the reference's
    prefill argmax on the same weights, where the reference's top two
    logits are apart by more than the tolerance."""
    jcfg, tcfg, jp, tp = model("yi-9b")
    out = tserve.serve("yi-9b", batch=4, prompt_len=16, max_new=3,
                       s_max=32, seed=0, params=tp, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, tcfg.vocab, size=(4, 16)).astype(np.int32)
    jl, _ = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(prompts)}, s_max=32)
    jl = np.asarray(jl.astype(jnp.float32))[:, :tcfg.vocab]
    top2 = np.sort(jl, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL * np.abs(jl).max()
    assert clear.any()
    assert np.array_equal(out["generated"][clear, 0],
                          jl.argmax(1)[clear])


def test_padded_vocab_ids_are_masked():
    """vocab 300 pads to 512: prefill and decode set ids 300.. to NEG (as
    bf16), forward_train leaves them (the loss masks them)."""
    cfg = dataclasses.replace(tconfigs.reduced_config("yi-9b"), vocab=300)
    assert cfg.vocab_padded == 512
    params = init_from_specs(TT.model_specs(cfg), 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 9, 7))
    neg = torch.tensor(TT.NEG, dtype=torch.bfloat16)
    with torch.inference_mode():
        lg, caches = TT.prefill(cfg, params, {"tokens": toks[:, :8]}, 16)
        dec, _ = TT.decode_step(cfg, params, caches, {"tokens": toks[:, 8:]})
        full = TT.forward_train(cfg, params, {"tokens": toks})
    for x in (lg, dec):
        assert bool((x[..., 300:] == neg).all())
        assert bool((x[..., :300] > -1e3).all())
    assert bool((full[..., 300:] > -1e3).all())


def test_decode_raises_when_the_cache_is_full():
    _, cfg, _, params = model("yi-9b")
    toks = torch.from_numpy(tokens(cfg, 1, 9, 6))
    with torch.inference_mode():
        _, caches = TT.prefill(cfg, params, {"tokens": toks[:, :8]}, s_max=8)
        with pytest.raises(ValueError, match="full"):
            TT.decode_step(cfg, params, caches, {"tokens": toks[:, 8:]})
        with pytest.raises(ValueError, match="prompt"):
            TT.prefill(cfg, params, {"tokens": toks}, s_max=8)


def test_lm_cli_runs_on_cpu(capsys):
    tserve.main(["--mode", "lm", "--arch", "yi-9b", "--device", "cpu",
                 "--batch", "2", "--max-new", "3"])
    assert "[serve] yi-9b: batch=2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "lm", "--device", "cpu"])


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_float32_replay_equals_the_upcast_tree(arch):
    """``float32_replay`` keeps the groups' attention / MLP / MoE weights
    in bf16, upcast where each product reads them: forward, prefill and a
    decode step give exactly the fully upcast tree's logits."""
    cfg = tconfigs.reduced_config(arch)
    params = init_from_specs(TT.model_specs(cfg), 5, device="cpu")
    full = {k: (v.float() if isinstance(v, torch.Tensor) else
                jax.tree.map(lambda t: t.float(), v))
            for k, v in params.items()}
    lean = float32_replay(params)
    kept = [k for k, v in lean["groups"]["0"].items()
            if any(t.dtype == torch.bfloat16
                   for t in jax.tree.leaves(v))]
    assert set(kept) <= {"attn", "cross", "mlp", "moe", "shared", "dense2"}
    assert bool(kept) == (cfg.kind != "rwkv")
    assert lean["embed"]["table"].dtype == torch.float32
    toks = torch.from_numpy(tokens(cfg, 2, 13, 9))
    _, tx = extras(cfg, 2, 9)
    out = []
    with torch.inference_mode():
        for p in (full, lean):
            f = TT.forward_train(cfg, p, {"tokens": toks, **tx})
            lg, c = TT.prefill(cfg, p, {"tokens": toks[:, :12], **tx}, 32)
            dec, _ = TT.decode_step(cfg, p, c, {"tokens": toks[:, 12:]})
            out.append((f, lg, dec))
    for a, b in zip(*out):
        assert a.dtype == torch.float32 and torch.equal(a, b)
