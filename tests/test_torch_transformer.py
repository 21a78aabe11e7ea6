"""PyTorch port, the decoder-only transformer and LM serving against the
JAX package.

For the four dense archs at ``reduced_config`` (``yi-9b``;
``mistral-nemo-12b``; ``starcoder2-15b`` with its sliding window, layer
norm, GELU MLP and qkv bias; ``qwen1.5-32b`` with qkv bias and the int8
KV cache, also with padded heads), the reference's weights
(``init_from_specs(..., PRNGKey)``) are carried over with
``params_from_numpy``, and ``forward_train``, ``prefill`` and
``decode_step`` logits are held to the reference's at 0.02 relative (max
abs difference over max abs, over the real vocab): the models run in bf16,
and the two frameworks round other partial sums to bf16
(``tests/test_serving.py``'s TOL).  The port's own decode is held to its
own forward the same way, step by step.  Every other family raises
``unported`` naming A15.3.
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
from repro_torch.models.common import init_from_specs  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 0.02
DENSE = ("yi-9b", "mistral-nemo-12b", "starcoder2-15b", "qwen1.5-32b",
         "qwen1.5-32b+padded")
OTHER = ("jamba-v0.1-52b", "rwkv6-7b", "seamless-m4t-large-v2",
         "arctic-480b", "qwen2-moe-a2.7b", "internvl2-26b")


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


@pytest.mark.parametrize("name", DENSE)
def test_forward_train_matches_reference(name):
    jcfg, tcfg, jp, tp = model(name)
    toks = tokens(tcfg, 2, 24, 2)
    want = JT.forward_train(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = TT.forward_train(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 24, tcfg.vocab_padded)
    assert rel(want, got, tcfg.vocab) < TOL


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits, its caches, and two decode steps' logits."""
    jcfg, tcfg, jp, tp = model(name)
    toks = tokens(tcfg, 2, 22, 3)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :20])},
                        s_max=64)
    with torch.inference_mode():
        tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(
            toks[:, :20])}, s_max=64)
    assert tl.shape == (2, tcfg.vocab_padded)
    assert rel(jl, tl, tcfg.vocab) < TOL
    for pos, c in tc.items():
        assert c.length == 20
        assert c.k.shape == jc[pos].k.shape and c.k.dtype == (
            torch.int8 if tcfg.kv_cache_dtype == "int8" else torch.bfloat16)
        assert not torch.any(c.k[:, :, 20:])
    for t in (20, 21):
        jd, jc = JT.decode_step(jcfg, jp, jc,
                                {"tokens": jnp.asarray(toks[:, t:t + 1])})
        with torch.inference_mode():
            td, tc = TT.decode_step(tcfg, tp, tc, {
                "tokens": torch.from_numpy(toks[:, t:t + 1])})
        assert td.shape == (2, 1, tcfg.vocab_padded)
        assert rel(jd, td, tcfg.vocab) < TOL, t
    assert all(c.length == 22 for c in tc.values())


@pytest.mark.parametrize("name", DENSE)
def test_multi_step_decode_matches_own_forward(name):
    """Decoding tokens one by one == the train forward over the whole
    sequence (tests/test_serving.py:54)."""
    _, cfg, _, params = model(name)
    s_pre, n_dec = 8, 6
    toks = torch.from_numpy(tokens(cfg, 1, s_pre + n_dec, 4))
    with torch.inference_mode():
        full = TT.forward_train(cfg, params, {"tokens": toks})
        _, caches = TT.prefill(cfg, params, {"tokens": toks[:, :s_pre]},
                               s_max=64)
        for t in range(n_dec):
            dec, caches = TT.decode_step(cfg, params, caches, {
                "tokens": toks[:, s_pre + t:s_pre + t + 1]})
            assert rel(full[:, s_pre + t], dec[:, -1], cfg.vocab) < TOL, t


@pytest.mark.parametrize("name", DENSE[:4])
def test_init_decode_caches_match_reference(name):
    jcfg, tcfg = configs(name)
    jc = JT.init_decode_caches(jcfg, 3, 40, abstract=True)
    tc = TT.init_decode_caches(tcfg, 3, 40, abstract=True)
    assert sorted(jc) == sorted(tc)
    for pos in jc:
        for f in ("k", "v", "k_scale", "v_scale"):
            j, t = getattr(jc[pos], f), getattr(tc[pos], f)
            assert (j is None) == (t is None), f
            if j is not None:
                assert tuple(t.shape) == j.shape and t.device.type == "meta"
                assert str(t.dtype).replace("torch.", "") \
                    == jnp.dtype(j.dtype).name
        assert tc[pos].length == 0


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_unported(arch):
    cfg = tconfigs.reduced_config(arch)
    calls = [lambda: TT.model_specs(cfg),
             lambda: TT.forward_train(cfg, {}, {"tokens": None}),
             lambda: TT.prefill(cfg, {}, {"tokens": None}, 16),
             lambda: TT.decode_step(cfg, {}, {}, {"tokens": None}),
             lambda: TT.init_decode_caches(cfg, 1, 16, device="cpu"),
             lambda: tserve.serve(arch, device="cpu")]
    for call in calls:
        with pytest.raises(NotImplementedError, match="A15.3"):
            call()


def test_unported_names_each_roadmap_item():
    families = {"moe models", "hybrid (mamba) models", "rwkv models",
                "encoder-decoder models", "vlm models"}
    assert families < set(UNPORTED)
    for k, item in UNPORTED.items():
        assert ("A15.3" in item) == (k in families), k
        assert k in families or ("Queue B" in item and "CUDA" in k), k


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
