"""PyTorch port, ``models.mamba`` against the JAX package's
``repro.models.mamba`` on the same numpy-seeded inputs and weights.

``mamba_train`` and ``mamba_prefill`` (output, final SSM state and the
bf16 conv tail) over sequences that are not a chunk multiple (the padded
dt = 0 steps), at chunk 8 and at the configs' chunk 64 (6 doubling steps
of the port's scan), then ``mamba_decode`` steps from the prefill's state.
Held to the reference at 1e-5 relative (max abs difference over max abs)
in float32 and 0.02 in bf16; the conv tail is bf16 in both (the
reference stores it so), and a float32 sum that differs in its last bit
may round to the neighbouring bf16 value, so the tail is held to the bf16
bound, and each decode step after a prefill starts from the reference's
state.  The weights are drawn so that dt spans
softplus's linear region past its threshold (20) as well as its curve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from repro.models import mamba as jmb  # noqa: E402
from repro_torch.models import mamba as tmb  # noqa: E402
from repro_torch.models.common import leaf_paths, set_leaf  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 0.02}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D, D_INNER, D_STATE, D_CONV, DT_RANK = 32, 48, 16, 4, 4


def rel(want, got):
    a = np.asarray(jnp.asarray(want).astype(jnp.float32))
    b = got.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)


def rounded(a, dtype):
    return np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


def params(dtype, seed=0):
    """(reference's, port's) Mamba weights of the same values: A = 1..16
    per state (Mamba's init) times a random factor, dt biases from -4 to
    24 so dt reaches past softplus's threshold."""
    rng = np.random.default_rng(seed)
    special = {
        "a_log": np.log(np.arange(1, D_STATE + 1, dtype=np.float32)[None]
                        * rng.uniform(0.5, 1.5, (D_INNER, D_STATE))),
        "dt_bias": np.linspace(-4.0, 24.0, D_INNER),
        "d_skip": rng.uniform(0.5, 1.5, D_INNER),
        "conv_b": rng.standard_normal(D_INNER) * 0.1,
    }
    jt, tt = {}, {}
    for path, s in leaf_paths(tmb.mamba_specs(D, D_INNER, D_STATE, D_CONV,
                                              DT_RANK)):
        name = path[-1]
        a = special.get(name)
        if a is None:
            a = rng.standard_normal(s.shape) * (0.2 if name != "conv_w"
                                                else 0.5)
        a = rounded(np.asarray(a, np.float32), dtype)
        set_leaf(jt, path, jnp.asarray(a, JDT[dtype]))
        set_leaf(tt, path, torch.from_numpy(a).to(TDT[dtype]))
    return jt, tt


def inputs(shape, dtype, seed):
    a = rounded(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32), dtype)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


KW = dict(d_state=D_STATE, dt_rank=DT_RANK)


def carried(js):
    """The reference's MambaState as the port's, bits kept."""
    conv = np.array(js.conv.astype(jnp.float32))
    return tmb.MambaState(h=torch.from_numpy(np.array(js.h)),
                          conv=torch.from_numpy(conv).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 8), (130, 64), (5, 64)])
def test_mamba_train_matches_reference(s, chunk, dtype):
    jp, tp = params(dtype)
    jx, tx = inputs((2, s, D), dtype, s)
    want = jmb.mamba_train(jp, jx, chunk=chunk, **KW)
    got = tmb.mamba_train(tp, tx, chunk=chunk, **KW)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    assert rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(20, 8), (130, 64)])
def test_mamba_prefill_and_decode_match_reference(s, chunk, dtype):
    """The prefill's output and state, then 3 decode steps from it."""
    jp, tp = params(dtype, seed=1)
    jx, tx = inputs((2, s + 3, D), dtype, 7)
    jy, js = jmb.mamba_prefill(jp, jx[:, :s], chunk=chunk, **KW)
    ty, ts = tmb.mamba_prefill(tp, tx[:, :s], chunk=chunk, **KW)
    assert rel(jy, ty) < TOL[dtype]
    assert ts.h.dtype == torch.float32 and ts.conv.dtype == torch.bfloat16
    assert rel(js.h, ts.h) < TOL[dtype]
    assert rel(js.conv, ts.conv) < TOL["bfloat16"]
    for t in range(s, s + 3):
        # each step from the reference's state: one bf16 flip of the tail
        # moves a float32 step's output by ~1e-4
        ts = carried(js)
        jy, js = jmb.mamba_decode(jp, jx[:, t:t + 1], js, **KW)
        ty, ts = tmb.mamba_decode(tp, tx[:, t:t + 1], ts, **KW)
        assert ty.shape == (2, 1, D) and ty.dtype == TDT[dtype]
        assert rel(jy, ty) < TOL[dtype], t
        assert rel(js.h, ts.h) < TOL[dtype], t
        assert rel(js.conv, ts.conv) < TOL["bfloat16"], t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_from_init_state_matches_reference(dtype):
    jp, tp = params(dtype, seed=2)
    js = jmb.mamba_init_state(jp, 3)
    ts = tmb.mamba_init_state(tp, 3)
    assert tuple(ts.h.shape) == js.h.shape and tuple(ts.conv.shape) \
        == js.conv.shape and ts.conv.dtype == torch.bfloat16
    jx, tx = inputs((3, 4, D), dtype, 9)
    for t in range(4):
        jy, js = jmb.mamba_decode(jp, jx[:, t:t + 1], js, **KW)
        ty, ts = tmb.mamba_decode(tp, tx[:, t:t + 1], ts, **KW)
        assert rel(jy, ty) < TOL[dtype], t
        assert rel(js.h, ts.h) < TOL[dtype], t


def test_scan_matches_a_sequential_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t run step by step
    (float64, a chunk of 64 with decays down to 1e-30)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(np.exp(-rng.uniform(0, 70, (2, 64, 3, 5))))
    b = torch.from_numpy(rng.standard_normal((2, 64, 3, 5)))
    dcum, hs = tmb._scan_chunk(a, b)
    h, p = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(64):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        assert torch.allclose(hs[:, t], h, rtol=1e-12, atol=1e-300)
        assert torch.allclose(dcum[:, t], p, rtol=1e-12, atol=1e-300)


def test_softplus_matches_reference_across_its_threshold():
    """``F.softplus`` switches to the identity past 20; ``jax.nn.softplus``
    is log1p(exp(-|x|)) + max(x, 0): equal within float32 there."""
    x = np.linspace(-40.0, 60.0, 20001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = F.softplus(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(want - got) <= 1e-6 * np.maximum(np.abs(want),
                                                          1e-30))
