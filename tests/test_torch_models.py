"""PyTorch port, LM scaffolding: configs, ``models.common``,
``models.convert`` and ``models.layers`` against the JAX package on the
same numpy-seeded inputs.

Configs must equal the reference's field for field.  Each layer function is
held to its reference in float32 at 1e-5 relative (max abs difference over
max abs; the two frameworks sum in other orders) and in bf16 at 8e-3 (one
bf16 ulp is ~0.4 %, and the two may round a float32 result to bf16 on
either side of a boundary).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    tensor_from_numpy,
)

TOL = {"float32": 1e-5, "bfloat16": 8e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = sorted(jconfigs.ARCHS)
DENSE = ("yi-9b", "mistral-nemo-12b", "starcoder2-15b", "qwen1.5-32b")


def rel_err(want, got):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    assert want.shape == got.shape, (want.shape, got.shape)
    return np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-9)


def rounded(shape, dtype, seed, scale=1.0):
    """float32 numpy values already rounded to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


def both(a, dtype):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


# --- configs ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for get in ("get_config", "reduced_config"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), get
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        for prop in ("vocab_padded", "n_heads_padded", "n_kv_padded",
                     "dt_rank", "d_inner", "n_groups"):
            assert getattr(t, prop) == getattr(j, prop), (get, prop)
        assert t.layer_kinds() == j.layer_kinds()
        assert t.group_kinds() == j.group_kinds()
        assert tconfigs.supported_shapes(t) == jconfigs.supported_shapes(j)


def test_registry_and_shapes_equal_reference():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


# --- models.common --------------------------------------------------------

def _jax_leaf_paths(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    return [(tuple(k.key for k in path), s) for path, s in flat]


@pytest.mark.parametrize("arch", DENSE)
def test_model_specs_equal_reference(arch):
    """Same leaves in the same (flatten) order, shapes, axes, init, scale
    and dtype; ``logical_axes`` too."""
    jspecs = JT.model_specs(jconfigs.get_config(arch))
    tspecs = TT.model_specs(tconfigs.get_config(arch))
    jl, tl = _jax_leaf_paths(jspecs), tcommon.leaf_paths(tspecs)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert (t.shape, t.axes, t.init, t.scale) \
            == (j.shape, j.axes, j.init, j.scale)
        assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name
    assert tcommon.logical_axes(tspecs) == jcommon.logical_axes(jspecs)


def test_param_spec_rejects_rank_mismatch():
    with pytest.raises(ValueError):
        tcommon.ParamSpec((2, 3), ("embed",))


def test_stack_specs_and_abstract_from_specs():
    specs = {"a": tcommon.ParamSpec((4, 3), ("embed", "ff")),
             "b": {"c": tcommon.ParamSpec((5,), ("embed",), init="ones",
                                          dtype=torch.float32)}}
    st = tcommon.stack_specs(specs, 6, axis_name="layers")
    assert st["a"].shape == (6, 4, 3) and st["a"].axes == ("layers",
                                                           "embed", "ff")
    assert st["b"]["c"].init == "ones" and st["b"]["c"].dtype == torch.float32
    ab = tcommon.abstract_from_specs(st)
    assert ab["a"].device.type == "meta" and ab["a"].shape == (6, 4, 3)
    assert ab["b"]["c"].dtype == torch.float32


def test_init_from_specs_is_seeded_per_leaf():
    specs = {"w": tcommon.ParamSpec((64, 32), ("embed", "ff"), scale=0.5),
             "z": tcommon.ParamSpec((7,), ("embed",), init="zeros"),
             "o": tcommon.ParamSpec((7,), ("embed",), init="ones",
                                    dtype=torch.float32),
             "v": tcommon.ParamSpec((64, 32), ("embed", "ff"))}
    a = tcommon.init_from_specs(specs, 3, device="cpu")
    b = tcommon.init_from_specs(specs, 3, device="cpu")
    c = tcommon.init_from_specs(specs, 4, device="cpu")
    for k in specs:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w"], c["w"])
    assert a["w"].dtype == torch.bfloat16 and a["o"].dtype == torch.float32
    assert not torch.any(a["z"]) and torch.all(a["o"] == 1)
    assert abs(float(a["w"].float().std()) - 0.5) < 0.05
    assert abs(float(a["v"].float().std()) - 0.02) < 0.002
    # each leaf draws from its own generator: another leaf's shape does not
    # move it
    other = dict(specs, w=tcommon.ParamSpec((3,), ("embed",)))
    assert torch.equal(tcommon.init_from_specs(other, 3, device="cpu")["v"],
                       a["v"])


def test_round_up_and_beinsum():
    assert [tcommon.round_up(x, 256) for x in (1, 256, 257, 64000)] \
        == [jcommon.round_up(x, 256) for x in (1, 256, 257, 64000)]
    x = rounded((2, 3, 16), "bfloat16", 1)
    w = rounded((16, 8), "bfloat16", 2)
    jx, tx = both(x, "bfloat16")
    jw, tw = both(w, "bfloat16")
    got = tcommon.beinsum("bsd,df->bsf", tx, tw)
    assert got.dtype == torch.bfloat16
    assert rel_err(jcommon.beinsum("bsd,df->bsf", jx, jw), got) < 8e-3
    mixed = tcommon.beinsum("bsd,df->bsf", tx, torch.from_numpy(w))
    assert mixed.dtype == torch.float32
    assert rel_err(jcommon.beinsum("bsd,df->bsf", jx, jnp.asarray(w)),
                   mixed) < 1e-5


# --- models.convert -------------------------------------------------------

@pytest.mark.parametrize("form", ["float32", "uint16", "ml_dtypes"])
def test_params_from_numpy_is_exact(form):
    cfg = jconfigs.reduced_config("starcoder2-15b")
    jp = jcommon.init_from_specs(JT.model_specs(cfg), jax.random.PRNGKey(0))
    if form == "float32":
        tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    elif form == "uint16":
        tree = jax.tree.map(
            lambda a: np.asarray(a).view(np.uint16)
            if a.dtype == jnp.bfloat16 else np.asarray(a), jp)
    else:
        tree = jax.tree.map(np.asarray, jp)
        assert tree["embed"]["table"].dtype == ml_dtypes.bfloat16
    tspecs = TT.model_specs(tconfigs.reduced_config("starcoder2-15b"))
    tp = params_from_numpy(tree, tspecs, "cpu")
    jflat = dict((tuple(k.key for k in p), v) for p, v in
                 jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, spec in tcommon.leaf_paths(tspecs):
        node = tp
        for k in path:
            node = node[k]
        assert node.dtype == spec.dtype and tuple(node.shape) == spec.shape
        want = np.asarray(jflat[path].astype(jnp.float32))
        assert np.array_equal(node.float().numpy(), want), path


def test_params_from_numpy_rejects_missing_or_misshapen_leaves():
    specs = {"a": {"w": tcommon.ParamSpec((2, 3), ("embed", "ff"))}}
    with pytest.raises(KeyError, match="a/w"):
        params_from_numpy({"a": {}}, specs, "cpu")
    with pytest.raises(ValueError, match="a/w"):
        params_from_numpy({"a": {"w": np.zeros((3, 2), np.float32)}}, specs,
                          "cpu")
    bits = np.array([0x3F80, 0xC000], np.uint16)     # 1.0, -2.0 in bf16
    assert tensor_from_numpy(bits, torch.bfloat16).tolist() == [1.0, -2.0]
    assert tensor_from_numpy(bits.astype(np.int32), torch.float32).tolist() \
        == [16256.0, 49152.0]


# --- models.layers --------------------------------------------------------

def _norm_params(kind, d, dtype, seed):
    p = {"scale": rounded((d,), dtype, seed, 0.5) + 1.0}
    if kind == "layer":
        p["bias"] = rounded((d,), dtype, seed + 1, 0.5)
    return p


def _pair(p, dtype):
    j, t = {}, {}
    for k, v in p.items():
        j[k], t[k] = both(np.asarray(v, np.float32), dtype)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_reference(kind, dtype):
    x = rounded((2, 5, 96), dtype, 3, 3.0) + 0.7
    jp, tp = _pair(_norm_params(kind, 96, dtype, 4), dtype)
    jx, tx = both(x, dtype)
    fj = jlayers.rms_norm if kind == "rms" else jlayers.layer_norm
    ft = tlayers.rms_norm if kind == "rms" else tlayers.layer_norm
    got = ft(tp, tx)
    assert got.dtype == TDT[dtype]
    assert rel_err(fj(jp, jx), got) < TOL[dtype]


@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
@pytest.mark.parametrize("batched", [False, True])
def test_rope_frequencies_match_reference(theta, batched):
    pos = np.arange(40, dtype=np.int32)
    if batched:
        pos = np.stack([pos, pos + 7])
    jc, js = jlayers.rope_frequencies(64, jnp.asarray(pos), theta)
    tc, ts = tlayers.rope_frequencies(64, torch.from_numpy(pos), theta)
    assert tc.dtype == torch.float32 and tc.shape == jc.shape
    assert np.max(np.abs(np.asarray(jc) - tc.numpy())) < 1e-5
    assert np.max(np.abs(np.asarray(js) - ts.numpy())) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_reference(dtype, batched):
    b, s, h, hd = 2, 12, 3, 64
    x = rounded((b, s, h, hd), dtype, 5)
    pos = np.arange(s, dtype=np.int32) + 3
    if batched:
        pos = np.stack([pos, pos + 11])
    jc, js = jlayers.rope_frequencies(hd, jnp.asarray(pos), 1e4)
    tc, ts = tlayers.rope_frequencies(hd, torch.from_numpy(pos), 1e4)
    jx, tx = both(x, dtype)
    got = tlayers.apply_rope(tx, tc, ts)
    assert got.dtype == TDT[dtype]
    assert rel_err(jlayers.apply_rope(jx, jc, js), got) < TOL[dtype]


def test_rope_is_split_halves():
    """Dimension i pairs with i + hd/2 (not 2i with 2i + 1)."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    cos = torch.full((1, 4), 0.0)
    sin = torch.full((1, 4), 1.0)
    out = tlayers.apply_rope(x, cos, sin)
    assert out[0, 0, 0].tolist() == [0, 0, 0, 0, 1, 0, 0, 0]


def _mlp_params(kind, d, ff, dtype, bias=True):
    if kind == "swiglu":
        return {"gate": rounded((d, ff), dtype, 6, 0.1),
                "up": rounded((d, ff), dtype, 7, 0.1),
                "down": rounded((ff, d), dtype, 8, 0.1)}
    p = {"up": rounded((d, ff), dtype, 9, 0.1),
         "down": rounded((ff, d), dtype, 10, 0.1)}
    if bias:
        p["up_b"] = rounded((ff,), dtype, 11, 0.1)
        p["down_b"] = rounded((d,), dtype, 12, 0.1)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu", "gelu_nobias"])
def test_mlps_match_reference(kind, dtype):
    x = rounded((2, 6, 64), dtype, 13)
    jp, tp = _pair(_mlp_params(kind.split("_")[0], 64, 160, dtype,
                               bias=kind == "gelu"), dtype)
    jx, tx = both(x, dtype)
    fj = jlayers.swiglu if kind == "swiglu" else jlayers.gelu_mlp
    ft = tlayers.swiglu if kind == "swiglu" else tlayers.gelu_mlp
    got = ft(tp, tx)
    assert got.dtype == TDT[dtype]
    assert rel_err(fj(jp, jx), got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_unembed_match_reference(dtype):
    table = rounded((300, 48), dtype, 14)
    toks = np.random.default_rng(15).integers(0, 300, (3, 7)).astype(
        np.int32)
    jp, tp = _pair({"table": table}, dtype)
    e = tlayers.embed(tp, torch.from_numpy(toks))
    assert np.array_equal(np.asarray(jlayers.embed(jp, jnp.asarray(toks))
                                     .astype(jnp.float32)), e.float().numpy())
    x = rounded((3, 7, 48), dtype, 16)
    jx, tx = both(x, dtype)
    assert rel_err(jlayers.unembed(jp, jx), tlayers.unembed(tp, tx)) \
        < TOL[dtype]


@pytest.mark.parametrize("kind", ["rms", "layer", "swiglu", "gelu",
                                  "embedding"])
def test_layer_specs_equal_reference(kind):
    make = {"rms": ("rmsnorm_specs", (96,)),
            "layer": ("layernorm_specs", (96,)),
            "swiglu": ("swiglu_specs", (96, 160)),
            "gelu": ("gelu_mlp_specs", (96, 160)),
            "embedding": ("embedding_specs", (512, 96))}[kind]
    name, args = make
    j = getattr(jlayers, name)(*args)
    t = getattr(tlayers, name)(*args)
    assert sorted(j) == sorted(t)
    for k in j:
        assert (t[k].shape, t[k].axes, t[k].init, t[k].scale) \
            == (j[k].shape, j[k].axes, j[k].init, j[k].scale)
