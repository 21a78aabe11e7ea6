"""PyTorch port, attention: the chunked online-softmax oracle and
``ops.flash_attention`` (its CPU path) against the JAX package on the same
numpy-seeded inputs.

``ops.flash_attention`` is held to JAX's ``mode="interpret"``, which runs
the Pallas kernel's body, on every case of ``tests/test_flash_attention.py``.
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
