"""PyTorch port, B5's decode body: ``ref.flash_decode_ref`` (the plain
version of ``csrc/flash_attention_decode.cu``: the visible keys cut by
``ref.decode_split``, each span's float32 partial softmax, the spans
combined in order) against the JAX package's ``flash_attention_pallas`` in
interpret mode and the port's oracles; the split's properties; how
``ops`` routes a call to the body; and a global batch of one on a
one-rank ``DeviceMesh``.

The Pallas kernel takes neither masks past causality nor an int8 cache,
so it gets what the decode query sees: the visible keys sliced out (and
dequantised in float32, the reference's ``chunked_attention`` does the
same chunk by chunk), non-causal, one query row a block.  Tolerance:
1e-5 relative (max abs difference over max abs) in float32.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5

DECODE_CASES = {
    # name: (b, h, k, hd, rows, kv_len, q_offset, window, causal, int8);
    # G = h / k query heads a KV head
    "g1_hd64": (2, 4, 4, 64, 200, 150, 149, None, False, False),
    "g4_hd128_causal": (2, 8, 2, 128, 300, 257, 256, None, True, False),
    "g6_many_spans": (1, 12, 2, 128, 1600, 1537, 1536, None, False, False),
    "g8_yi_decode": (4, 32, 4, 128, 600, 513, 512, None, False, False),
    "g12_window": (2, 48, 4, 128, 700, 617, 616, 200, True, False),
    "g12_int8_window": (2, 24, 2, 64, 300, 290, 289, 100, False, True),
    "g8_int8_hd128": (2, 16, 2, 128, 400, 333, 332, None, False, True),
    "g4_q_offset": (1, 8, 2, 64, 100, 90, 40, None, True, False),
    "g4_one_key_int8": (3, 4, 1, 64, 32, 1, 0, None, True, True),
    "g20_row_chunks": (1, 20, 1, 64, 150, 130, 129, None, False, False),
    "g2_sp_rank_past_rows": (1, 4, 2, 64, 16, 16, 21, 12, True, True),
}


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-9))


def _case(name):
    """float32 q (B, 1, H, hd), k / v (B, rows, K, hd) as numpy, junk past
    kv_len; int8 K / V with their scales (``quantize_kv``) as tensors."""
    b, h, kk, hd, rows, kv_len, q_off, window, causal, q8 = \
        DECODE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, rows, kk, hd)).astype(np.float32)
            for _ in range(2))
    k[:, kv_len:] = 1e4
    v[:, kv_len:] = -1e4
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    ks = vs = None
    if q8:
        (tk, ks), (tv, vs) = tattn.quantize_kv(tk), tattn.quantize_kv(tv)
    kw = dict(kv_len=kv_len, window=window, q_offset=q_off, k_scale=ks,
              v_scale=vs)
    return torch.from_numpy(q), tk, tv, causal, kw


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_ref_matches_pallas_interpret(name):
    """The decode body's plain version equals the Pallas kernel (interpret
    mode) on the keys the query sees, the port's chunked oracle
    (``flash_attention_ref``) and its lse (``attention_lse_ref``)."""
    q, k, v, causal, kw = _case(name)
    out, lse = ref.flash_decode_ref(q, k, v, causal, **kw)
    b, _, h, hd = q.shape
    assert out.shape == q.shape and out.dtype == torch.float32
    assert lse.shape == (b, h, 1) and lse.dtype == torch.float32
    split = ref.decode_split(b, h, k.shape[2], kw["kv_len"], causal,
                             kw["window"], kw["q_offset"])
    lo, hi = split.lo, split.hi
    kf, vf = k.float(), v.float()
    if kw["k_scale"] is not None:
        kf, vf = kf * kw["k_scale"].float(), vf * kw["v_scale"].float()
    jk, jv = (jnp.asarray(np.moveaxis(t[:, lo:hi + 1].numpy(), 1, 2))
              for t in (kf, vf))
    want = flash_attention_pallas(
        jnp.asarray(np.moveaxis(q.numpy(), 1, 2)), jk, jv, causal=False,
        block_q=1, block_k=hi + 1 - lo, interpret=True)
    assert rel_err(np.moveaxis(np.asarray(want), 1, 2), out) < TOL
    oracle = ref.flash_attention_ref(q, k, v, causal, **kw)
    assert rel_err(oracle.numpy(), out) < TOL
    want_lse = ref.attention_lse_ref(q, k, causal, kw["kv_len"],
                                     window=kw["window"],
                                     q_offset=kw["q_offset"],
                                     k_scale=kw["k_scale"])
    assert torch.allclose(lse, want_lse, atol=TOL, rtol=TOL)


def test_decode_ref_matches_the_reference_oracle():
    """Yi-9B's decode call at reduced width through the JAX package's own
    ``chunked_attention`` (window, kv_valid_len, int8 scales), on the same
    numpy inputs."""
    for name in ("g12_int8_window", "g4_q_offset"):
        q, k, v, causal, kw = _case(name)
        rows = k.shape[1]
        jks = jvs = None
        if kw["k_scale"] is not None:
            jks, jvs = (jnp.asarray(kw[s].float().numpy()).astype(
                jnp.bfloat16) for s in ("k_scale", "v_scale"))
        want = jattn.chunked_attention(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()),
            jnp.asarray(np.array([kw["q_offset"]], np.int32)),
            jnp.arange(rows, dtype=jnp.int32), causal=causal,
            chunk=min(512, rows), window=kw["window"],
            kv_valid_len=jnp.int32(kw["kv_len"]), k_scale=jks, v_scale=jvs)
        got, _lse = ref.flash_decode_ref(q, k, v, causal, **kw)
        assert rel_err(np.asarray(want), got) < TOL, name


def test_decode_ref_keeps_bf16_and_rejects_more_rows():
    q, k, v, causal, kw = _case("g8_yi_decode")
    out, _ = ref.flash_decode_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  causal, **kw)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="one query row"):
        ref.flash_decode_ref(torch.zeros(1, 2, 4, 64), k[:1, :, :1, :64],
                             v[:1, :, :1, :64], True)


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 8), kk=st.integers(1, 8), g=st.integers(1, 40),
       kv_len=st.integers(1, 20000), back=st.integers(0, 300),
       window=st.one_of(st.none(), st.integers(1, 9000)),
       causal=st.booleans())
def test_decode_split_covers_every_visible_key_once(b, kk, g, kv_len, back,
                                                    window, causal):
    """Every visible key lies in exactly one span, the spans are whole
    tiles in order with none empty of visible keys, their number is at
    most what fills ``DECODE_BLOCKS`` blocks, and the split is a function
    of the call's shape alone."""
    q_off = max(0, kv_len - 1 - back) if causal else kv_len - 1
    if window is not None and q_off + 1 - window >= kv_len:
        window = None
    args = (b, g * kk, kk, kv_len, causal, window, q_off)
    split = ref.decode_split(*args)
    assert split == ref.decode_split(*args)
    t = ref.DECODE_TILE
    hi = min(q_off, kv_len - 1) if causal else kv_len - 1
    lo = 0 if window is None else max(0, q_off - window + 1)
    assert (split.lo, split.hi) == (lo, hi)
    spans = split.spans()
    assert len(spans) == split.splits >= 1
    assert spans[0][0] == lo // t * t and spans[-1][1] == (hi // t + 1) * t
    for (a, e), (a2, _) in zip(spans, spans[1:]):
        assert e == a2
    for a, e in spans:
        assert a % t == 0 and e % t == 0 and e > a
        assert max(a, lo) <= min(e - 1, hi)          # sees a key
    chunks = -(-g // ref.DECODE_ROWS)
    assert split.splits <= max(1, -(-ref.DECODE_BLOCKS // (b * kk * chunks)))
    keys = np.arange(lo, hi + 1)
    owners = sum(((keys >= a) & (keys < e)).astype(int) for a, e in spans)
    assert (owners == 1).all()


def test_decode_constants_match_the_kernel():
    """``ref.DECODE_TILE`` and ``DECODE_ROWS`` are the decode body's kBK and
    kRows: the split's tiles are the kernel's."""
    text = (build.CSRC / "flash_attention_decode.cu").read_text()
    assert re.findall(r"constexpr int kBK = (\d+);", text) == [
        str(ref.DECODE_TILE)]
    assert re.findall(r"constexpr int kRows = (\d+);", text) == [
        str(ref.DECODE_ROWS)]
    head = text[:2500]
    assert "flash_attention.py:flash_attention_pallas" in head
    assert "Bound on the card" in head


@pytest.mark.parametrize("dtype, sq, symbol", [
    (torch.bfloat16, 1, "attn_flash_decode"),
    (torch.float32, 1, "attn_flash_attention"),
    (torch.bfloat16, 3, "attn_flash_attention")])
@pytest.mark.parametrize("int8", [False, True])
def test_launch_routes_bf16_decode_calls_to_the_decode_body(dtype, sq, symbol,
                                                            int8,
                                                            monkeypatch):
    """``ops._flash_launch`` (what ``flash_attention`` and
    ``flash_attention_fwd`` run on the card) sends every bf16 call with one
    query row to ``attn_flash_decode`` with ``decode_split``'s spans and a
    workspace of (hd + 2) float32 a span and query head, counted under
    ``flash_attention`` and ``flash_decode``; every other call to
    ``attn_flash_attention``.  The launch is stubbed (no card here); the
    argument count is the ctypes signature's."""
    calls, works = [], []
    monkeypatch.setattr(ops, "_launch",
                        lambda name, dev, *a, symbol=None: calls.append(
                            (name, symbol, a)))
    real_work = ops._decode_work
    monkeypatch.setattr(ops, "_decode_work", lambda q, split: works.append(
        real_work(q, split)) or works[-1])
    b, h, kk, hd, rows, kv_len = 2, 24, 2, 64, 300, 290
    q = torch.zeros(b, sq, h, hd, dtype=dtype)
    k = torch.zeros(b, rows, kk, hd, dtype=torch.int8 if int8 else dtype)
    sc = torch.ones(b, rows, kk, 1, dtype=torch.bfloat16) if int8 else None
    lse = torch.empty(b, h, sq)
    ops.reset_launches()
    try:
        ops._flash_launch(q, k, k, True, kv_len, lse, window=100,
                          q_offset=kv_len - sq, k_scale=sc, v_scale=sc)
        decode = dict(ops.LAUNCHES)["flash_decode"]
    finally:
        ops.reset_launches()
    ((name, sym, args),) = calls
    assert (name, sym) == ("flash_attention", symbol)
    assert len(args) + 1 == len(build.SIGNATURES[symbol])     # + stream
    assert args[4] == lse.data_ptr()
    assert (args[5] is None) == (not int8)
    if symbol != "attn_flash_decode":
        assert decode == 0 and works == []
        return
    split = ref.decode_split(b, h, kk, kv_len, True, 100, kv_len - 1)
    assert decode == 1
    assert args[9:] == (b, h, kk, kv_len, rows, hd, 1, 100, kv_len - 1,
                        split.splits, split.per_split)
    (work,) = works
    assert args[8] == work.data_ptr()
    assert work.dtype == torch.float32
    assert work.numel() == b * h * split.splits * (hd + 2)


# ------------------------------------- a global batch of one on one rank

ONE_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys, tempfile
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs, map_specs
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import make_mesh
    from repro_torch.train import steps as S

    store = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{store}/s",
                            rank=0, world_size=1)
    try:
        cfg = reduced_config("yi-9b")
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        specs = map_specs(lambda s: dataclasses.replace(
            s, dtype=torch.float32), T.model_specs(cfg))
        params = init_from_specs(specs, 0, "cpu")
        g = torch.Generator().manual_seed(3)
        tok = torch.randint(0, cfg.vocab, (1, 65), generator=g,
                            dtype=torch.int32)
        batch = {"tokens": tok[:, :64], "targets": tok[:, 1:]}
        out = {}
        one, *_ = S.make_train_step(cfg, None, "train_4k", donate=False,
                                    keep_grads=True)
        _, _, m1 = one(params, S.init_opt_state(cfg, params), batch, 5)
        step, _rules, psh, osh = S.make_train_step(
            cfg, mesh, "train_4k", donate=False, keep_grads=True)
        p = S.shard_tree(params, psh)
        _, _, m = step(p, S.init_opt_state(cfg, p, osh), batch, 5)
        grads = S.gather_tree(m["grads"])
        out["loss"] = [float(m["loss"]), float(m1["loss"])]
        out["grad_err"] = max(
            float((a - w).abs().max() / (w.abs().max() + 1e-30))
            for a, w in zip(tree_leaves(grads), tree_leaves(m1["grads"])))
        out["leaves"] = len(tree_leaves(grads))
        logits = []
        for mesh_ in (None, mesh):
            pre, *_ = S.make_prefill_step(cfg, mesh_, "decode_32k", s_max=32)
            dec, _r, psh_, _c = S.make_decode_step(cfg, mesh_, "decode_32k")
            pp = params if psh_ is None else S.shard_tree(params, psh_)
            lg, caches = pre(pp, {"tokens": tok[:, :16]})
            for i in range(3):
                lg, caches = dec(pp, caches, {"tokens": tok[:, 16 + i:17 + i]})
            logits.append(lg)
        out["decode_equal"] = bool(torch.equal(*logits))
        out["decode_shape"] = list(logits[1].shape)
    finally:
        dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
""")


def test_batch_of_one_on_a_one_rank_mesh_is_the_one_device_step():
    """``make_train_step`` on a (1, 1) ``DeviceMesh`` of one gloo rank with
    a global batch of 1 x 64 (reduced yi-9b, float32): its loss and every
    gradient leaf equal the one-device step's (1e-5), and
    ``make_decode_step`` at batch 1 on the same mesh gives the one-device
    logits.  A batch dimension of size one sharded over a mesh dimension
    of size one used to fail inside DTensor's einsum."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run([sys.executable, "-c", ONE_RANK_SCRIPT],
                         capture_output=True, text=True, timeout=240,
                         env=env, cwd=REPO)
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT")]
    assert res.returncode == 0 and line, res.stderr[-4000:]
    out = json.loads(line[-1][len("RESULT"):])
    got, want = out["loss"]
    assert abs(got - want) <= TOL * abs(want)
    assert out["leaves"] > 0 and out["grad_err"] <= TOL
    assert out["decode_equal"] and out["decode_shape"][0] == 1
