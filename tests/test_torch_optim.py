"""PyTorch port, the optimizer (``repro_torch.optim``) against the JAX
package (``repro.optim``) on the same numpy-seeded inputs.

Tolerances: the schedule within 1e-7 (its cosine may round an ulp apart:
XLA's float32 cos is not correctly rounded); AdamW's float32 results
within 1e-6 relative (``global_norm`` sums its leaves' squares in another
order, so the clip factor can differ in its last bit); bf16 results equal
or one bf16 ulp apart (that last bit can round a bf16 value either way);
the int8 compression bit for bit.  The reference's own tests
(``tests/test_optim.py``) are restated against the port at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as jopt  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim import compress as tcomp  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

SHAPES = {"attn": {"wq": (24, 4, 8), "wo": (4, 8, 24)},
          "embed": {"table": (37, 24)}, "norm": (24,)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def both(arrays, dtype):
    """(jax tree, torch tree) of float32 numpy arrays cast to ``dtype``
    (rounded once, in JAX, so both hold the same values)."""
    rounded = _map(arrays, lambda a: np.array(
        jnp.asarray(a, JDT[dtype]).astype(jnp.float32)))
    j = _map(rounded, lambda a: jnp.asarray(a, JDT[dtype]))
    t = _map(rounded, lambda a: torch.from_numpy(a).to(TDT[dtype]))
    return j, t


def _map(t, fn):
    if isinstance(t, dict):
        return {k: _map(v, fn) for k, v in t.items()}
    return fn(t)


def draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tree(SHAPES, lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32))


def close(want, got, dtype):
    """float32: within 1e-6 relative; bf16: at most one ulp apart."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    assert w.shape == g.shape
    if dtype == "float32":
        assert np.max(np.abs(w - g)) <= 1e-6 * (np.max(np.abs(w)) + 1e-30)
    else:
        wb = np.asarray(jnp.asarray(want, jnp.bfloat16)).view(np.int16)
        gb = got.view(torch.int16).numpy()
        assert np.max(np.abs(wb.astype(np.int32) - gb.astype(np.int32))) <= 1


# --- schedule -----------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 100, 1000),
                                               (3e-3, 5, 100),
                                               (3e-4, 0, 7)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    """Warmup, decay and the tail past total_steps."""
    for step in list(range(0, total + 20)) + [5 * total]:
        want = float(jopt.cosine_schedule(jnp.int32(step), peak_lr=peak,
                                          warmup_steps=warmup,
                                          total_steps=total))
        got = topt.cosine_schedule(step, peak_lr=peak, warmup_steps=warmup,
                                   total_steps=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-7, step


# --- AdamW --------------------------------------------------------------

@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype, state_dtype, clip):
    """Three updates from the same params, grads and state, the port's
    first and third in place: params, m, v, count and grad_norm."""
    jp, tp = both(draw(0), param_dtype)
    js = jopt.adamw_init(jp, JDT[state_dtype])
    ts = topt.adamw_init(tp, TDT[state_dtype])
    scale = 10.0 if clip == "active" else 0.01
    for it in range(3):
        jg, tg = both(draw(10 + it, scale), param_dtype)
        lr = jopt.cosine_schedule(jnp.int32(it + 3), peak_lr=1e-3,
                                  warmup_steps=2, total_steps=50)
        jp, js, jm = jopt.adamw_update(jg, js, jp, lr)
        tp, ts, tm = topt.adamw_update(tg, ts, tp, float(lr),
                                       in_place=(it != 1))
        gn = float(jm["grad_norm"])
        assert (gn > 1.0) == (clip == "active")
        assert abs(float(tm["grad_norm"]) - gn) <= 1e-6 * gn
    assert int(ts.count) == int(js.count) == 3
    for jt, tt, dt in ((jp, tp, param_dtype), (js.m, ts.m, state_dtype),
                       (js.v, ts.v, state_dtype)):
        for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
            assert str(b.dtype) == f"torch.{dt}"
            close(a, b, dt)


def test_adamw_in_place_returns_the_given_tensors():
    _, tp = both(draw(1), "float32")
    st = topt.adamw_init(tp)
    _, tg = both(draw(2), "float32")
    before = tp["norm"].clone()
    new, st2, _ = topt.adamw_update(tg, st, tp, 1e-3, in_place=True)
    assert new["norm"] is tp["norm"] and st2.m["norm"] is st.m["norm"]
    assert st2.count is st.count and int(st.count) == 1
    assert not torch.equal(before, tp["norm"])


def test_global_norm_sums_every_leaf_in_float32():
    j, t = both(draw(3), "bfloat16")
    want = float(jopt.global_norm(j))
    got = topt.global_norm(t)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


# --- compression --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_ef_compress_bit_equal(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(300) * 3).astype(np.float32)
    x[7] = 0.0
    jx, tx = both({"x": x}, dtype)
    jq, js = jcomp.quantize_int8(jx["x"])
    tq, ts = tcomp.quantize_int8(tx["x"])
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert np.float32(js) == ts.numpy()
    np.testing.assert_array_equal(np.asarray(jcomp.dequantize_int8(jq, js)),
                                  tcomp.dequantize_int8(tq, ts).numpy())
    err = rng.standard_normal(300).astype(np.float32) * 0.01
    jq, js, je = jcomp.ef_compress(jx["x"], jnp.asarray(err))
    tq, ts, te = tcomp.ef_compress(tx["x"], torch.from_numpy(err))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())


def test_quantize_all_zeros():
    q, s = tcomp.quantize_int8(torch.zeros(5))
    assert not torch.any(q) and float(s) == pytest.approx(1e-12 / 127.0)


# --- the reference's own tests (tests/test_optim.py) on the port --------

def test_adamw_converges_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params)
    for _ in range(300):
        grads = {"x": 2 * params["x"]}
        params, state, _ = topt.adamw_update(grads, state, params, lr=0.05,
                                             weight_decay=0.0)
    assert float(params["x"].abs().max()) < 0.05


def test_grad_clipping():
    params = {"x": torch.zeros(4)}
    state = topt.adamw_init(params)
    _, _, metrics = topt.adamw_update({"x": torch.full((4,), 1e6)}, state,
                                      params, lr=1e-3, clip_norm=1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_bf16_state_dtype():
    params = {"x": torch.zeros(4, dtype=torch.bfloat16)}
    state = topt.adamw_init(params, torch.bfloat16)
    assert state.m["x"].dtype == torch.bfloat16
    p2, s2, _ = topt.adamw_update({"x": torch.ones(4, dtype=torch.bfloat16)},
                                  state, params, lr=1e-2)
    assert p2["x"].dtype == torch.bfloat16
    assert s2.v["x"].dtype == torch.bfloat16


def test_cosine_schedule():
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(topt.cosine_schedule(0, **kw)) == 0.0
    assert float(topt.cosine_schedule(10, **kw)) == pytest.approx(1e-3)
    assert float(topt.cosine_schedule(100, **kw)) == pytest.approx(
        1e-4, rel=0.05)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(
        np.float32))
    q, scale = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-7


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    err = torch.zeros(64)
    true_sum = np.zeros(64)
    comp_sum = np.zeros(64)
    for _ in range(200):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        true_sum += g.numpy()
        q, scale, err = tcomp.ef_compress(g, err)
        comp_sum += tcomp.dequantize_int8(q, scale).numpy()
    np.testing.assert_allclose(true_sum - comp_sum, err.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(err.abs().max()) < 0.2


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(topt.global_norm(t)) == pytest.approx(5.0)
