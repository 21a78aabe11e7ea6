"""PyTorch port, ``models.rwkv`` against the JAX package's
``repro.models.rwkv`` on the same numpy-seeded inputs and weights.

``rwkv_time_mix`` (output, the float32 WKV state and the last token) and
``rwkv_channel_mix`` (output and the last token), each from zeros and from
a carried state, over several tokens and over one (a decode step).  Held
to the reference at 1e-5 relative (max abs difference over max abs) in
float32 and 0.02 in bf16.  The per-head group norm's population variance
is covered there: an unbiased one would scale every output by
sqrt(15 / 16) at hd 16, 3 % off.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import rwkv as jrk  # noqa: E402
from repro_torch.models import rwkv as trk  # noqa: E402
from repro_torch.models.common import leaf_paths, set_leaf  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 0.02}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D, H, LORA, FF = 64, 4, 8, 96


def rel(want, got):
    a = (want.float().numpy() if isinstance(want, torch.Tensor)
         else np.asarray(jnp.asarray(want).astype(jnp.float32)))
    b = got.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)


def rounded(a, dtype):
    return np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


def both(a, dtype):
    a = rounded(np.asarray(a, np.float32), dtype)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def params(specs, dtype, seed):
    """(reference's, port's) weights of the same values: normal times each
    spec's scale, the mixing coefficients in (0, 1), w0 from -1 to 1 (so
    the decays spread over (0, 1)), the LoRA at 0.3."""
    rng = np.random.default_rng(seed)
    jt, tt = {}, {}
    for path, s in leaf_paths(specs):
        name = path[-1]
        if name.startswith("mu_"):
            a = rng.uniform(0.0, 1.0, s.shape)
        elif name == "w0":
            a = np.linspace(-1.0, 1.0, s.shape[0])
        elif name == "ln_scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.standard_normal(s.shape) * (
                0.3 if name in ("w_a", "w_b") else s.scale * 5)
        j, t = both(a, dtype)
        set_leaf(jt, path, j)
        set_leaf(tt, path, t)
    return jt, tt


def state(dtype, seed, b=2):
    """A carried state: (reference's, port's) RwkvState."""
    rng = np.random.default_rng(seed)
    wkv = rng.standard_normal((b, H, D // H, D // H)).astype(np.float32)
    sh_t, sh_c = (both(rng.standard_normal((b, D)), dtype) for _ in range(2))
    return (jrk.RwkvState(jnp.asarray(wkv), sh_t[0], sh_c[0]),
            trk.RwkvState(torch.from_numpy(wkv), sh_t[1], sh_c[1]))


def inputs(shape, dtype, seed):
    return both(np.random.default_rng(seed).standard_normal(shape), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 1])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_reference(carried, s, dtype):
    jp, tp = params(trk.rwkv_time_specs(D, H, LORA), dtype, 0)
    jx, tx = inputs((2, s, D), dtype, s)
    js, ts = state(dtype, 5) if carried else (None, None)
    jy, (jwkv, jlast) = jrk.rwkv_time_mix(jp, jx, state=js, n_heads=H)
    ty, (twkv, tlast) = trk.rwkv_time_mix(tp, tx, state=ts, n_heads=H)
    assert ty.dtype == TDT[dtype] and ty.shape == tx.shape
    assert twkv.dtype == torch.float32 and twkv.shape == (2, H, D // H,
                                                          D // H)
    assert rel(jy, ty) < TOL[dtype]
    assert rel(jwkv, twkv) < TOL[dtype]
    assert torch.equal(tlast, tx[:, -1])
    assert rel(jlast, tlast) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 1])
@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_reference(carried, s, dtype):
    jp, tp = params(trk.rwkv_channel_specs(D, FF), dtype, 1)
    jx, tx = inputs((2, s, D), dtype, 20 + s)
    js, ts = state(dtype, 6) if carried else (None, None)
    jy, jlast = jrk.rwkv_channel_mix(jp, jx, None if js is None
                                     else js.shift_c)
    ty, tlast = trk.rwkv_channel_mix(tp, tx, None if ts is None
                                     else ts.shift_c)
    assert ty.dtype == TDT[dtype] and ty.shape == tx.shape
    assert rel(jy, ty) < TOL[dtype]
    assert torch.equal(tlast, tx[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_steps_equal_one_pass(dtype):
    """Token by token with the state carried == one pass over the
    sequence (the decode path against the prefill path)."""
    _, tp = params(trk.rwkv_time_specs(D, H, LORA), dtype, 2)
    _, tx = inputs((2, 6, D), dtype, 3)
    full, (wkv_full, _) = trk.rwkv_time_mix(tp, tx, n_heads=H)
    st = None
    for t in range(6):
        y, (wkv, last) = trk.rwkv_time_mix(tp, tx[:, t:t + 1], state=st,
                                           n_heads=H)
        st = trk.RwkvState(wkv, last, last)
        assert rel(full[:, t:t + 1], y) < TOL[dtype], t
    assert rel(wkv_full, wkv) < 1e-6
