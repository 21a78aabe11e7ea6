"""PyTorch port, attention: the chunked online-softmax oracle,
``ops.flash_attention`` (its CPU path, ``kv_len`` included) and the rest of
``models/attention.py`` (projections, RoPE, prefill, decode over the KV
cache, cross attention, padded heads) against the JAX package on the same
numpy-seeded inputs.

``ops.flash_attention`` is held to JAX's ``mode="interpret"``, which runs
the Pallas kernel's body, on every case of ``tests/test_flash_attention.py``;
its gradient (the plain version of B5-bwd) to ``jax.grad`` of the
reference's ``chunked_attention``, and ``flash_attention_fwd``'s row
log-sum-exp to JAX's ``logsumexp``.
Tolerances are relative (max abs difference over max abs): 1e-5 in float32,
8e-3 in bfloat16 (one bf16 ulp is ~0.4 %, and the two sides may round the
float32 result to bf16 on either side of a boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 8e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def qkv(b, sq, h, k, hd, skv=None, seed=0, dtype="bfloat16"):
    """float32 numpy q (B,Sq,H,hd), k/v (B,Skv,K,hd), already rounded to
    ``dtype`` so both frameworks get the same values."""
    rng = np.random.default_rng(seed)
    skv = skv or sq
    out = []
    for shape in ((b, sq, h, hd), (b, skv, k, hd), (b, skv, k, hd)):
        x = rng.standard_normal(shape).astype(np.float32)
        out.append(np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32)))
    return out


def J(arrays, dtype):
    return [jnp.asarray(a, JDT[dtype]) for a in arrays]


def T(arrays, dtype):
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]


def rel_err(want, got):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    assert want.shape == got.shape
    return np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-9)


# --- chunked_attention against the JAX oracle ---------------------------

ORACLE_CASES = {
    # name: (b, sq, h, k, hd, skv, chunk, kwargs)
    "causal_mha": (1, 64, 4, 4, 64, 64, 16, dict(causal=True)),
    "full_gqa_ragged_skv": (2, 48, 8, 2, 64, 40, 16, dict(causal=False)),
    "causal_mqa_hd128": (1, 40, 4, 1, 128, 40, 16, dict(causal=True)),
    "window": (1, 64, 4, 2, 64, 64, 16, dict(causal=True, window=8)),
    "kv_valid_len": (2, 8, 4, 2, 64, 48, 16,
                     dict(causal=False, kv_valid_len=30)),
    "decode_offset": (1, 4, 4, 2, 64, 50, 16, dict(causal=True)),
    "int8_cache": (1, 32, 4, 2, 64, 40, 16, dict(causal=True, quant=True)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_chunked_attention_matches_reference(case, dtype):
    b, sq, h, k, hd, skv, chunk, kw = ORACLE_CASES[case]
    kw = dict(kw)
    quant = kw.pop("quant", False)
    q, kk, v = qkv(b, sq, h, k, hd, skv, seed=len(case), dtype=dtype)
    # queries sit at the end of the KV range (a prefill continuing a cache)
    pos_q = np.arange(skv - sq, skv, dtype=np.int32)
    pos_k = np.arange(skv, dtype=np.int32)
    jq, jk, jv = J((q, kk, v), dtype)
    tq, tk, tv = T((q, kk, v), dtype)
    jextra, textra = {}, {}
    if quant:
        jk8, jks = jattn.quantize_kv(jk)
        jv8, jvs = jattn.quantize_kv(jv)
        tk8, tks = tattn.quantize_kv(tk)
        tv8, tvs = tattn.quantize_kv(tv)
        jk, jv, tk, tv = jk8, jv8, tk8, tv8
        jextra = dict(k_scale=jks, v_scale=jvs)
        textra = dict(k_scale=tks, v_scale=tvs)
    if "kv_valid_len" in kw:
        jextra["kv_valid_len"] = jnp.int32(kw["kv_valid_len"])
        textra["kv_valid_len"] = torch.tensor(kw.pop("kv_valid_len"),
                                              dtype=torch.int32)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(pos_q),
                                   jnp.asarray(pos_k), chunk=chunk, **kw,
                                   **jextra)
    got = tattn.chunked_attention(tq, tk, tv, torch.from_numpy(pos_q),
                                  torch.from_numpy(pos_k), chunk=chunk, **kw,
                                  **textra)
    assert got.dtype == TDT[dtype]
    assert rel_err(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    x = qkv(2, 24, 2, 3, 64, seed=9, dtype=dtype)[0]
    x[0, 0, 0] = 0.0                                # an all-zero (token, head)
    j8, js = jattn.quantize_kv(jnp.asarray(x, JDT[dtype]))
    t8, ts = tattn.quantize_kv(torch.from_numpy(x).to(TDT[dtype]))
    assert t8.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(j8), t8.numpy())
    assert np.array_equal(np.asarray(js.astype(jnp.float32)),
                          ts.float().numpy())


@pytest.mark.parametrize("parts", [2, 4])
def test_quantize_kv_of_head_dim_parts_is_the_whole_heads(parts):
    """``quantize_kv`` of a part of the head dims, its max magnitude
    taken to the whole head's by ``reduce_amax`` (what the all-reduce
    over the ranks that split ``head_dim`` gives), is that part of the
    whole heads' quantisation, and its scale theirs."""
    x = torch.from_numpy(qkv(2, 24, 2, 3, 64, seed=9, dtype="float32")[0])
    x[0, 0, 0] = 0.0
    w8, ws = tattn.quantize_kv(x)
    chunks = x.chunk(parts, dim=-1)
    amax = torch.stack([c.abs().amax(-1, keepdim=True)
                        for c in chunks]).amax(0)
    for c, want in zip(chunks, w8.chunk(parts, dim=-1)):
        got, scale = tattn.quantize_kv(c, lambda a: torch.maximum(a, amax))
        assert torch.equal(got, want) and torch.equal(scale, ws)


def test_count_kv_rows_counts_no_cpu_call():
    """On the CPU B5's plain version runs and nothing is counted; the
    output is the same inside the block and out."""
    q, k, v = T(qkv(1, 1, 4, 2, 64, seed=3, skv=40, dtype="float32"),
                "float32")
    kw = dict(causal=True, kv_len=30, window=8, q_offset=29)
    with ops.count_kv_rows() as got:
        out = ops.flash_attention(q, k, v, **kw)
    assert got == []
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))


def test_chunked_attention_rejects_head_mismatch():
    q, k, v = T(qkv(1, 8, 3, 2, 64, dtype="float32"), "float32")
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tattn.chunked_attention(q, k, v, pos, pos, causal=True)


# --- ops.flash_attention against the Pallas kernel in interpret mode ----

FLASH_CASES = {
    # tests/test_flash_attention.py: (b, sq, h, k, hd, skv, causal, dtype)
    "mha_causal": (1, 256, 4, 4, 64, None, True, "bfloat16"),
    "mha_full": (1, 256, 4, 4, 64, None, False, "bfloat16"),
    "gqa_causal": (2, 512, 8, 2, 64, None, True, "bfloat16"),
    "gqa_full": (2, 512, 8, 2, 64, None, False, "bfloat16"),
    "mqa_hd128_causal": (1, 512, 4, 1, 128, None, True, "bfloat16"),
    "mqa_hd128_full": (1, 512, 4, 1, 128, None, False, "bfloat16"),
    "unpadded_300_causal": (1, 300, 4, 4, 64, None, True, "bfloat16"),
    "cross_256_512_full": (1, 256, 4, 4, 64, 512, False, "bfloat16"),
    "fp32_causal": (1, 256, 2, 2, 64, None, True, "float32"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_pallas_interpret(case):
    b, sq, h, k, hd, skv, causal, dtype = FLASH_CASES[case]
    arrays = qkv(b, sq, h, k, hd, skv, seed=sum(map(ord, case)), dtype=dtype)
    want = jops.flash_attention(*J(arrays, dtype), causal=causal,
                                mode="interpret")
    got = ops.flash_attention(*T(arrays, dtype), causal=causal)
    assert got.dtype == TDT[dtype] and got.is_contiguous()
    assert rel_err(want, got) < TOL[dtype]


def test_flash_attention_block_skip_case():
    """The reference's block-skip case: 1024 positions, 128-row blocks of
    the Pallas kernel called directly, against the port's op."""
    arrays = qkv(1, 1024, 2, 2, 64, seed=5)
    jq, jk, jv = (jnp.moveaxis(a, 2, 1) for a in J(arrays, "bfloat16"))
    want = jnp.moveaxis(flash_attention_pallas(
        jq, jk, jv, causal=True, block_q=128, block_k=128, interpret=True),
        1, 2)
    got = ops.flash_attention(*T(arrays, "bfloat16"), causal=True)
    assert rel_err(want, got) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_more_queries_than_keys(dtype):
    """Causal, Sq=300 > Skv=200, Skv not a multiple of 256: the port equals
    the reference's oracle (``mode="ref"``).

    The reference's Pallas path (``mode="interpret"``, and ``"pallas"`` on
    the TPU) differs there: its wrapper pads KV to 256 with zero keys and
    relies on the causal mask to hide them, but query rows at positions
    >= 200 lie at or past the padded keys' positions, so those rows put
    softmax mass on zero keys (``test_reference_pallas_path_differs_past_skv``
    measures it).  The port's kernel masks ``k_pos >= Skv`` itself and
    follows the oracle.
    """
    arrays = qkv(1, 300, 2, 2, 64, skv=200, seed=14, dtype=dtype)
    want = jops.flash_attention(*J(arrays, dtype), causal=True, mode="ref")
    got = ops.flash_attention(*T(arrays, dtype), causal=True)
    assert rel_err(want, got) < TOL[dtype]


def test_reference_pallas_path_differs_past_skv():
    """The reference fault the test above steps around, measured: at
    (Sq, Skv) = (300, 200), causal, float32, the Pallas path in interpret
    mode leaves the oracle in query rows >= 200 only."""
    arrays = J(qkv(1, 300, 2, 2, 64, skv=200, seed=14, dtype="float32"),
               "float32")
    want = np.asarray(jops.flash_attention(*arrays, causal=True, mode="ref"))
    pallas = np.asarray(jops.flash_attention(*arrays, causal=True,
                                             mode="interpret"))
    diff = np.abs(want - pallas).max(axis=(0, 2, 3))
    assert diff[:200].max() < 1e-5
    assert diff[200:].max() > 1e-2


def test_flash_attention_ref_is_the_oracle_at_arange():
    arrays = qkv(1, 40, 4, 2, 64, skv=24, seed=2, dtype="float32")
    q, k, v = T(arrays, "float32")
    pos_q = torch.arange(40, dtype=torch.int32)
    pos_k = torch.arange(24, dtype=torch.int32)
    for causal in (True, False):
        assert torch.equal(
            ref.flash_attention_ref(q, k, v, causal),
            tattn.chunked_attention(q, k, v, pos_q, pos_k, causal=causal,
                                    chunk=24))


@pytest.mark.parametrize("bad", ["float16", "hd32", "heads", "noncontig",
                                 "kv_shape", "mixed_dtype", "empty_kv",
                                 "three_d"])
def test_flash_attention_rejects_bad_inputs(bad):
    q, k, v = T(qkv(1, 16, 4, 2, 64, dtype="float32"), "float32")
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "hd32":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), \
            v[..., :32].contiguous()
    elif bad == "heads":
        q = torch.cat([q, q[:, :, :1]], dim=2)
    elif bad == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "kv_shape":
        v = v[:, :8].contiguous()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "empty_kv":
        k, v = k[:, :0], v[:, :0]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=True)


def test_flash_attention_keeps_empty_queries():
    q, k, v = T(qkv(2, 8, 4, 2, 64, dtype="float32"), "float32")
    out = ops.flash_attention(q[:, :0], k, v, causal=True)
    assert out.shape == (2, 0, 4, 64)


# --- the gradient of flash_attention (B5-bwd's plain version) ----------

GRAD_CASES = {
    # (b, sq, h, k, hd, skv, causal): G = H / K is 1 or 4
    "causal_g1": (2, 40, 4, 4, 64, None, True),
    "causal_g4": (2, 40, 8, 2, 64, None, True),
    "causal_ragged_g4_hd128": (1, 45, 4, 1, 128, None, True),
    "causal_more_queries_g1": (1, 45, 2, 2, 64, 30, True),
    "full_cross_g1": (2, 24, 4, 4, 64, 37, False),
    "full_ragged_g4": (1, 33, 8, 2, 128, 45, False),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_attention_grad_matches_reference(case):
    """dq, dk, dv of ``ops.flash_attention`` (autograd on the CPU path)
    against ``jax.grad`` of the reference's ``chunked_attention`` (what XLA
    differentiates in the reference's models), float32, within 1e-5; and
    ``ops.flash_attention_bwd`` returns the same gradients."""
    import jax
    b, sq, h, k, hd, skv, causal = GRAD_CASES[case]
    skv = skv or sq
    arrays = qkv(b, sq, h, k, hd, skv, seed=sum(map(ord, case)),
                 dtype="float32")
    do = np.random.default_rng(9).standard_normal((b, sq, h, hd)).astype(
        np.float32)
    pos_q, pos_k = jnp.arange(sq, dtype=jnp.int32), jnp.arange(
        skv, dtype=jnp.int32)

    def loss(q, k_, v):
        out = jattn.chunked_attention(q, k_, v, pos_q, pos_k, causal=causal,
                                      chunk=min(512, skv))
        return jnp.sum(out * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*J(arrays, "float32"))
    q, kk, v = (t.requires_grad_(True) for t in T(arrays, "float32"))
    out = ops.flash_attention(q, kk, v, causal=causal)
    out.backward(torch.from_numpy(do))
    for w, t in zip(want, (q, kk, v)):
        assert rel_err(w, t.grad) < TOL["float32"]
    tout, lse = ops.flash_attention_fwd(*(x.detach() for x in (q, kk, v)),
                                        causal=causal)
    assert torch.equal(tout, out.detach())
    got = ops.flash_attention_bwd(*(x.detach() for x in (q, kk, v)), tout,
                                  torch.from_numpy(do), lse, causal)
    for g, t in zip(got, (q, kk, v)):
        assert g.dtype == t.dtype and torch.equal(g, t.grad)


WINDOW_GRAD_CASES = {
    # name: (b, sq, h, k, hd, skv, causal, window): Sq not a multiple of
    # 64; a window that binds (narrower than Sq) and one that does not
    "causal_g1_binds": (2, 70, 4, 4, 64, None, True, 9),
    "causal_g6_binds": (1, 77, 12, 2, 64, None, True, 16),
    "causal_g6_wide": (1, 45, 6, 1, 128, None, True, 100),
    "causal_g1_one": (1, 33, 2, 2, 64, None, True, 1),
    "full_g6_binds": (1, 40, 6, 1, 64, 57, False, 12),
}


@pytest.mark.parametrize("case", sorted(WINDOW_GRAD_CASES))
def test_flash_attention_window_grad_matches_reference(case):
    """Under a sliding window: dq, dk, dv of ``ops.flash_attention``
    (autograd on the CPU path) against ``jax.grad`` of the reference's
    ``chunked_attention(..., window=w)``, float32, within 1e-5; and
    ``ops.flash_attention_bwd(..., window=w)`` returns the same
    gradients."""
    import jax
    b, sq, h, k, hd, skv, causal, window = WINDOW_GRAD_CASES[case]
    skv = skv or sq
    arrays = qkv(b, sq, h, k, hd, skv, seed=sum(map(ord, case)),
                 dtype="float32")
    do = np.random.default_rng(10).standard_normal((b, sq, h, hd)).astype(
        np.float32)
    pos_q, pos_k = jnp.arange(sq, dtype=jnp.int32), jnp.arange(
        skv, dtype=jnp.int32)

    def loss(q, k_, v):
        out = jattn.chunked_attention(q, k_, v, pos_q, pos_k, causal=causal,
                                      chunk=min(512, skv), window=window)
        return jnp.sum(out * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*J(arrays, "float32"))
    q, kk, v = (t.requires_grad_(True) for t in T(arrays, "float32"))
    out = ops.flash_attention(q, kk, v, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    for w, t in zip(want, (q, kk, v)):
        assert rel_err(w, t.grad) < TOL["float32"]
    tout, lse = ops.flash_attention_fwd(*(x.detach() for x in (q, kk, v)),
                                        causal=causal, window=window)
    got = ops.flash_attention_bwd(*(x.detach() for x in (q, kk, v)), tout,
                                  torch.from_numpy(do), lse, causal,
                                  window=window)
    for g, t in zip(got, (q, kk, v)):
        assert g.dtype == t.dtype and torch.equal(g, t.grad)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fwd_lse_is_the_logsumexp(causal):
    """The lse B5 writes for its backward: each query row's log-sum-exp
    of its scaled, masked scores, against JAX's logsumexp."""
    import jax
    arrays = qkv(2, 30, 4, 2, 64, skv=30 if causal else 21, seed=3,
                 dtype="float32")
    q, k, _ = J(arrays, "float32")
    s = jnp.einsum("bqkgd,bckd->bkgqc", q.reshape(2, 30, 2, 2, 64) / 8.0, k)
    if causal:
        s = jnp.where(jnp.arange(30)[:, None] >= jnp.arange(30)[None, :], s,
                      -jnp.inf)
    want = jax.nn.logsumexp(s, axis=-1).reshape(2, 4, 30)
    _, lse = ops.flash_attention_fwd(*T(arrays, "float32"), causal=causal)
    assert lse.shape == (2, 4, 30) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_attention_bwd_rejects_bad_inputs():
    q, k, v = T(qkv(1, 16, 4, 2, 64, dtype="float32"), "float32")
    out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, out[:, :8], out, lse, True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, out, out.bfloat16(), lse, True)


# --- flash_attention's kv_len against chunked_attention(kv_valid_len=) --

KV_LEN_CASES = {
    # name: (b, sq, h, k, hd, rows, kv_len, causal, dtype)
    "decode_b4": (4, 1, 8, 2, 128, 96, 51, False, "bfloat16"),
    "decode_ragged_b2": (2, 1, 4, 1, 64, 200, 77, False, "float32"),
    "decode_full": (2, 1, 4, 2, 64, 40, 40, False, "bfloat16"),
    "decode_one_key": (3, 1, 4, 4, 64, 32, 1, False, "float32"),
    "prefill_in_cache": (1, 24, 4, 2, 64, 64, 24, True, "bfloat16"),
    "cross_masked": (2, 12, 4, 2, 128, 48, 30, False, "float32"),
}


@pytest.mark.parametrize("case", sorted(KV_LEN_CASES))
def test_flash_attention_kv_len_matches_reference(case):
    """Keys at and past kv_len are masked; rows past it hold junk that
    must not reach the output.  Held to the reference's oracle with
    kv_valid_len, both the op's CPU path and ``flash_attention_ref``."""
    b, sq, h, k, hd, rows, kv_len, causal, dtype = KV_LEN_CASES[case]
    q, kk, v = qkv(b, sq, h, k, hd, rows, seed=len(case), dtype=dtype)
    kk[:, kv_len:] = 1e4
    v[:, kv_len:] = -1e4
    pos_q = np.arange(sq, dtype=np.int32)
    pos_k = np.arange(rows, dtype=np.int32)
    jq, jk, jv = J((q, kk, v), dtype)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(pos_q),
                                   jnp.asarray(pos_k), causal=causal,
                                   chunk=min(512, rows),
                                   kv_valid_len=jnp.int32(kv_len))
    tq, tk, tv = T((q, kk, v), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    assert rel_err(want, got) < TOL[dtype]
    assert torch.equal(got, ref.flash_attention_ref(tq, tk, tv, causal,
                                                    kv_len))
    # the same function as the visible keys alone
    alone = ops.flash_attention(tq, tk[:, :kv_len].contiguous(),
                                tv[:, :kv_len].contiguous(), causal=causal)
    assert rel_err(alone.float().numpy(), got) < TOL[dtype]


@pytest.mark.parametrize("bad", [0, 41, -1, 2.0, True, "tensor"])
def test_flash_attention_rejects_bad_kv_len(bad):
    q, k, v = T(qkv(1, 1, 4, 2, 64, skv=40, dtype="float32"), "float32")
    if bad == "tensor":
        bad = torch.tensor(5)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, causal=False, kv_len=bad)
    assert ops.flash_attention(q, k, v, causal=False,
                               kv_len=np.int64(40)).shape == q.shape


WINDOW_CASES = {
    # name: (b, sq, h, k, hd, rows, kv_len, q_offset, window, causal,
    #        int8, dtype)
    "prefill_window": (2, 40, 4, 2, 64, 40, 40, 0, 9, True, False,
                       "bfloat16"),
    "prefill_window_one": (1, 33, 4, 1, 128, 33, 33, 0, 1, True, False,
                           "float32"),
    "decode_window": (3, 1, 8, 2, 64, 96, 70, 69, 16, True, False,
                      "float32"),
    "decode_window_edge": (2, 1, 4, 2, 128, 64, 64, 63, 64, True, False,
                           "bfloat16"),
    "decode_int8": (4, 1, 8, 2, 128, 96, 51, 50, None, True, True,
                    "bfloat16"),
    "decode_int8_one_key": (2, 1, 4, 4, 64, 32, 1, 0, None, True, True,
                            "float32"),
    "decode_int8_window": (2, 1, 4, 2, 64, 80, 77, 76, 20, True, True,
                           "float32"),
    "sp_rank_past_rows": (1, 1, 4, 2, 64, 16, 16, 21, 12, True, True,
                          "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_flash_attention_window_and_int8_match_reference(case):
    """A sliding window (query row i at key position q_offset + i) and an
    int8 cache (``quantize_kv``'s values and bf16 scales, the reference's
    on the same numpy inputs) against the reference's
    ``chunked_attention`` with ``window`` / ``k_scale`` / ``v_scale``;
    ``lse`` against the log-sum-exp of the same masked, dequantised
    scores.  The rows past kv_len hold junk that must not reach the
    output.  ``sp_rank_past_rows`` is a sequence-parallel rank whose 16
    rows all lie before the query (position 21)."""
    b, sq, h, k, hd, rows, kv_len, q_off, window, causal, q8, dtype = \
        WINDOW_CASES[case]
    q, kk, v = qkv(b, sq, h, k, hd, rows, seed=len(case), dtype=dtype)
    kk[:, kv_len:] = 1e4
    v[:, kv_len:] = -1e4
    pos_q = np.arange(sq, dtype=np.int32) + q_off
    pos_k = np.arange(rows, dtype=np.int32)
    jq, jk, jv = J((q, kk, v), dtype)
    tq, tk, tv = T((q, kk, v), dtype)
    jks = jvs = tks = tvs = None
    if q8:
        jk, jks = jattn.quantize_kv(jk)
        jv, jvs = jattn.quantize_kv(jv)
        tk, tks = tattn.quantize_kv(tk)
        tv, tvs = tattn.quantize_kv(tv)
        assert np.array_equal(np.asarray(jk), tk.numpy())
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(pos_q),
                                   jnp.asarray(pos_k), causal=causal,
                                   chunk=min(512, rows), window=window,
                                   kv_valid_len=jnp.int32(kv_len),
                                   k_scale=jks, v_scale=jvs)
    kw = dict(causal=causal, kv_len=kv_len, window=window, q_offset=q_off,
              k_scale=tks, v_scale=tvs)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    assert rel_err(want, got) < TOL[dtype]
    out, lse = ops.flash_attention_fwd(tq, tk, tv, **kw)
    assert torch.equal(out, got)
    kf = tk.float() * tks.float() if q8 else tk.float()
    # query head i reads KV head i // (H / K)
    s = torch.einsum("bqhd,bchd->bhqc", tq.float(),
                     kf.repeat_interleave(h // k, dim=2)) / hd ** 0.5
    p, c = pos_q[:, None], pos_k[None, :]
    vis = (c < kv_len) & (c <= p if causal else True)
    if window is not None:
        vis = vis & (p - c < window)
    s = s.masked_fill(~torch.from_numpy(vis), float("-inf"))
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["window0", "no_key", "offset", "scales"])
def test_flash_attention_rejects_bad_window_and_scales(bad):
    q, k, v = T(qkv(1, 4, 4, 2, 64, skv=40, dtype="float32"), "float32")
    kw = {"window0": dict(window=0), "no_key": dict(window=2, q_offset=38,
                                                    kv_len=40),
          "offset": dict(q_offset=-1),
          "scales": dict(k_scale=torch.ones(1, 40, 2, 1,
                                            dtype=torch.bfloat16))}[bad]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, causal=False, **kw)


# --- the rest of models/attention.py against the reference ---------------

def attn_params(d, h, kv, hd, bias, dtype, seed):
    """float32 numpy attention weights rounded to ``dtype``; biases
    non-zero so that they count."""
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, h, hd)) * 0.05,
         "wk": rng.standard_normal((d, kv, hd)) * 0.05,
         "wv": rng.standard_normal((d, kv, hd)) * 0.05,
         "wo": rng.standard_normal((h, hd, d)) * 0.05}
    if bias:
        p.update(bq=rng.standard_normal((h, hd)) * 0.1,
                 bk=rng.standard_normal((kv, hd)) * 0.1,
                 bv=rng.standard_normal((kv, hd)) * 0.1)
    out = {}
    for name, a in p.items():
        a = np.asarray(a, np.float32)
        out[name] = np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    return out


def both_params(p, dtype):
    return ({k: jnp.asarray(v, JDT[dtype]) for k, v in p.items()},
            {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in p.items()})


def act(shape, dtype, seed):
    """float32 numpy activations rounded to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


ATTN_CASES = {
    # name: (h, kv, hd, bias, window, quantize, chunk)
    "gqa": (4, 2, 64, False, None, False, 16),
    "mha_bias": (4, 4, 32, True, None, False, 8),
    "window": (4, 2, 64, True, 6, False, 16),
    "int8": (4, 2, 64, True, None, True, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_train_and_prefill_match_reference(case, dtype):
    h, kv, hd, bias, window, quant, chunk = ATTN_CASES[case]
    d, b, s, s_max = 48, 2, 20, 32
    jp, tp = both_params(attn_params(d, h, kv, hd, bias, dtype, 1), dtype)
    x = act((b, s, d), dtype, 2)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    pos = np.arange(s, dtype=np.int32)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    want = jattn.attention_train(jp, jx, jpos, n_heads=h, n_kv=kv,
                                 head_dim=hd, rope_theta=1e4, chunk=chunk,
                                 window=window)
    got = tattn.attention_train(tp, tx, tpos, n_heads=h, n_kv=kv,
                                head_dim=hd, rope_theta=1e4, chunk=chunk,
                                window=window)
    assert rel_err(want, got) < TOL[dtype]
    jy, jc = jattn.attention_prefill(jp, jx, jpos, s_max, rope_theta=1e4,
                                     chunk=chunk, window=window,
                                     quantize=quant)
    ty, tc = tattn.attention_prefill(tp, tx, tpos, s_max, rope_theta=1e4,
                                     chunk=chunk, window=window,
                                     quantize=quant)
    assert rel_err(jy, ty) < TOL[dtype]
    assert tc.length == s and int(jc.length) == s
    assert tc.k.shape == jc.k.shape and tc.k.dtype == (
        torch.int8 if quant else TDT[dtype])
    assert not torch.any(tc.k[:, s:]) and not torch.any(tc.v[:, s:])
    if quant:
        # int8 codes may differ by one where bf16 k rounds differently
        assert np.abs(np.asarray(jc.k, np.int32)
                      - tc.k.numpy().astype(np.int32)).max() <= 1
        assert rel_err(jc.k_scale.astype(jnp.float32), tc.k_scale) < 8e-3
    else:
        assert rel_err(jc.k.astype(jnp.float32), tc.k) < TOL[dtype]
        assert rel_err(jc.v.astype(jnp.float32), tc.v) < TOL[dtype]
    # a given cache is filled in place
    buf = tattn.new_cache((b,), s_max, kv, hd, TDT[dtype], "cpu", quant)
    ty2, tc2 = tattn.attention_prefill(tp, tx, tpos, s_max, rope_theta=1e4,
                                       chunk=chunk, window=window,
                                       quantize=quant, cache=buf)
    assert tc2.k is buf.k and torch.equal(ty2, ty)
    assert torch.equal(buf.k, tc.k) and torch.equal(buf.v, tc.v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_decode_matches_reference(case, dtype):
    """Three decode steps after a prefill: outputs, the cache rows written
    in place, and the length."""
    h, kv, hd, bias, window, quant, chunk = ATTN_CASES[case]
    d, b, s, s_max = 48, 2, 9, 24
    jp, tp = both_params(attn_params(d, h, kv, hd, bias, dtype, 3), dtype)
    x = act((b, s + 3, d), dtype, 4)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    pos = np.arange(s, dtype=np.int32)
    _, jc = jattn.attention_prefill(jp, jx[:, :s], jnp.asarray(pos), s_max,
                                    rope_theta=1e4, chunk=chunk,
                                    window=window, quantize=quant)
    _, tc = tattn.attention_prefill(tp, tx[:, :s], torch.from_numpy(pos),
                                    s_max, rope_theta=1e4, chunk=chunk,
                                    window=window, quantize=quant)
    for t in range(s, s + 3):
        jy, jc = jattn.attention_decode(jp, jx[:, t:t + 1], jc,
                                        rope_theta=1e4, window=window)
        k_before = tc.k
        ty, tc = tattn.attention_decode(tp, tx[:, t:t + 1], tc,
                                        rope_theta=1e4, window=window)
        assert tc.k is k_before and tc.length == t + 1
        assert rel_err(jy, ty) < TOL[dtype], t
        if not quant:
            assert rel_err(jc.k[:, t].astype(jnp.float32), tc.k[:, t]) \
                < TOL[dtype]
    assert int(jc.length) == tc.length == s + 3


def test_attention_decode_rejects_a_full_cache():
    jp, tp = both_params(attn_params(16, 2, 2, 32, False, "float32", 5),
                         "float32")
    cache = tattn.new_cache((1,), 4, 2, 32, torch.float32, "cpu")
    x = torch.zeros((1, 1, 16))
    with pytest.raises(ValueError, match="full"):
        tattn.attention_decode(tp, x, cache._replace(length=4))


@pytest.mark.parametrize("valid", [None, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_project_memory_match_reference(valid, dtype):
    h, kv, hd, d, b, sq, sm = 4, 2, 64, 48, 2, 5, 17
    jp, tp = both_params(attn_params(d, h, kv, hd, False, dtype, 6), dtype)
    x, mem = act((b, sq, d), dtype, 7), act((b, sm, d), dtype, 8)
    jmk, jmv = jattn.project_memory(jp, jnp.asarray(mem, JDT[dtype]))
    tmk, tmv = tattn.project_memory(tp, torch.from_numpy(mem).to(TDT[dtype]))
    assert rel_err(jmk, tmk) < TOL[dtype] and rel_err(jmv, tmv) < TOL[dtype]
    want = jattn.cross_attention(jp, jnp.asarray(x, JDT[dtype]), jmk, jmv,
                                 None if valid is None else jnp.int32(valid))
    got = tattn.cross_attention(tp, torch.from_numpy(x).to(TDT[dtype]), tmk,
                                tmv, valid)
    assert rel_err(want, got) < TOL[dtype]


@pytest.mark.parametrize("pad", ["none", "heads", "heads_and_kv"])
def test_mask_padded_heads_and_specs_match_reference(pad):
    h, kv = 8, 4
    real_h = 6 if pad != "none" else None
    real_k = 3 if pad == "heads_and_kv" else None
    jp, tp = both_params(attn_params(16, h, kv, 32, True, "float32", 9),
                         "float32")
    want = jattn.mask_padded_heads(jp, real_h, real_k)
    got = tattn.mask_padded_heads(tp, real_h, real_k)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    js = jattn.attention_specs(16, h, kv, 32, qkv_bias=True)
    ts = tattn.attention_specs(16, h, kv, 32, qkv_bias=True)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert (ts[k].shape, ts[k].axes, ts[k].init) \
            == (js[k].shape, js[k].axes, js[k].init)
    assert sorted(tattn.cross_attention_specs(16, h, kv, 32)) \
        == sorted(jattn.cross_attention_specs(16, h, kv, 32))
