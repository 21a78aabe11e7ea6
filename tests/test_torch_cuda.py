"""PyTorch port on the card: the CUDA kernels against their plain versions
(flash attention included) and the CUDA engine against the CPU engine.
Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card the ``cuda`` tests skip; ``chip_smoke.py`` is the full
check on the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch import graphgen  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiles(rows, d, seed, device, real_weights=False, n_labels=None):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, d)) < 0.8
    mask[0] = False
    w = (rng.uniform(0.1, 5.0, size=(rows, d)) if real_weights
         else rng.integers(1, 5, size=(rows, d)))
    n_labels = n_labels or max(rows // 2, 2)
    arrays = dict(
        nbr=rng.integers(0, rows, size=(rows, d)).astype(np.int32),
        nw=w.astype(np.float32),
        nmask=mask,
        labels=rng.integers(0, n_labels, size=rows).astype(np.int32),
        comm=rng.integers(0, 4, size=rows).astype(np.int32),
        chg=rng.random(rows) < 0.3,
        active=rng.random(rows) < 0.6, cand_prev=rng.random(rows) < 0.4,
        klass=rng.random(rows) < 0.7, real=np.arange(rows) < rows - 2)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(64, 1), (64, 4), (32, 40), (8, 1024),
                                    (64, 3), (64, 8), (256, 64), (16, 512),
                                    # every narrow instance, the first wide
                                    # width and unaligned wide rows
                                    (64, 2), (64, 5), (64, 6), (64, 7),
                                    (64, 9), (64, 16), (64, 32), (64, 33),
                                    (32, 128)])
def test_cuda_kernels_match_plain_versions(rows, d):
    """Integer weights: every kernel equals its plain version exactly;
    fused_split equals min_label without prune and with every vertex
    changed."""
    need_card()
    t = tiles(rows, d, seed=3, device="cuda")
    for s in (0, -1, 12345):
        k = ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], s)
        p = ref.label_argmax_ref(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                 s)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        margs = (t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                 t["active"], t["cand_prev"], t["klass"], t["real"], s)
        k = ops.fused_move(*margs)
        p = ref.fused_move_ref(*margs)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    sargs = (t["nbr"], t["nmask"], t["labels"], t["comm"])
    m = ops.min_label(*sargs)
    assert torch.equal(m, ref.min_label_ref(*sargs))
    for prune in (True, False):
        for chg in (t["chg"], torch.ones_like(t["chg"])):
            got = ops.fused_split(*sargs, chg, prune)
            assert torch.equal(got, ref.fused_split_ref(*sargs, chg, prune))
            if not prune or bool(chg.all()):
                assert torch.equal(got, m)
    torch.cuda.synchronize()


def bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,n_labels", [
    (4096, 4, None), (1024, 64, None), (1024, 64, 6), (128, 512, None),
    (128, 512, 5), (256, 40, 3)])
def test_cuda_argmax_bits_equal_slot_order_sum(rows, d, n_labels):
    """Real weights: label_argmax and fused_move give the bits of the
    slot-order sum (narrow rows, compacted O(r^2) rows, sorted rows with
    long runs of one label)."""
    need_card()
    t = tiles(rows, d, seed=d, device="cuda", real_weights=True,
              n_labels=n_labels)
    for s in (0, -1, 12345):
        got = ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], s)
        want = ref.label_argmax_slot_order(t["nbr"], t["nw"], t["nmask"],
                                           t["labels"], s)
        assert all(bits_equal(a, b) for a, b in zip(got, want)), s
        bl, bw, cw = want
        new, act = ops.fused_move(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                  t["chg"], t["active"], t["cand_prev"],
                                  t["klass"], t["real"], s)
        wake = (t["chg"][t["nbr"].long()] & t["nmask"]).any(dim=1)
        act_want = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
        adopt = act_want & t["klass"] & (bw > cw.clamp_min(0.0))
        assert torch.equal(act, act_want)
        assert torch.equal(new, torch.where(adopt, bl, t["labels"]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 64, 512])
@pytest.mark.parametrize("state", ["inactive", "no_klass", "known_act"])
def test_cuda_fused_move_early_exits(d, state):
    """fused_move's early exits give the plain version's outputs: every
    row inactive (act only from the wake), klass false everywhere (no
    argmax), active && !cand_prev everywhere (no wake)."""
    need_card()
    t = tiles(256 if d < 512 else 64, d, seed=5, device="cuda")
    ones = torch.ones_like(t["active"])
    zeros = torch.zeros_like(t["active"])
    if state == "inactive":
        t["active"] = zeros
    elif state == "no_klass":
        t["klass"] = zeros
    else:
        t["active"], t["cand_prev"] = ones, zeros
    for s in (0, 7):
        args = (t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                t["active"], t["cand_prev"], t["klass"], t["real"], s)
        got = ops.fused_move(*args)
        want = ref.fused_move_ref(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), s
    if state == "no_klass":
        assert torch.equal(got[0], t["labels"])
    if state == "known_act":
        assert bool(got[1].all())


@pytest.mark.cuda
def test_cuda_argmax_rejects_unaligned_tiles():
    need_card()
    t = tiles(9, 4, seed=0, device="cuda")
    nbr = t["nbr"].flatten()[1:33].view(8, 4)     # 4 bytes past a vector
    with pytest.raises(ValueError):
        ops.label_argmax(nbr, t["nw"][:8], t["nmask"][:8], t["labels"], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 64])
def test_cuda_split_kernels_reject_unaligned_tiles(d):
    """min_label and fused_split load nbr and the mask as vectors, so a
    tile one element into its storage raises."""
    need_card()
    t = tiles(9, d, seed=0, device="cuda")
    nbr = t["nbr"].flatten()[1:8 * d + 1].view(8, d)
    nmask = t["nmask"].flatten()[1:8 * d + 1].view(8, d)
    for tile in ((nbr, t["nmask"][:8]), (t["nbr"][:8], nmask)):
        with pytest.raises(ValueError):
            ops.min_label(*tile, t["labels"], t["comm"])
        with pytest.raises(ValueError):
            ops.fused_split(*tile, t["labels"], t["comm"], t["chg"], True)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["none", "lp"])
def test_cuda_segment_fit_real_weights_matches_cpu(split):
    """Real weights on the segment backend: the CUDA fit equals the CPU
    fit (which equals the JAX package's, tests/test_torch_core.py) and
    repeats exactly; its run sums fold in index order on both devices."""
    need_card()
    g = graphgen.weighted_planted_partition(40, 500, 0.05, 0.001, seed=3)
    cfg = dict(split=split, backend="segment")
    want = Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache()).fit(g)
    runs = [Engine(EngineConfig(**cfg), cache=PlanCache()).fit(g)
            for _ in range(2)]
    for got in runs:
        assert got.device.startswith("cuda")
        assert np.array_equal(got.labels, want.labels)
        assert (got.lpa_iterations, got.split_iterations) == \
            (want.lpa_iterations, want.split_iterations)
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 300, size=200_000))
    val = rng.uniform(0.1, 5.0, size=seg.size).astype(np.float32)
    from repro_torch.core.lpa import segment_sum
    sums = [segment_sum(torch.from_numpy(val).to(dev),
                        torch.from_numpy(seg).to(dev), 300).cpu()
            for dev in ("cpu", "cuda", "cuda")]
    assert all(bits_equal(sums[0], x) for x in sums[1:])


@pytest.mark.cuda
def test_cuda_kernels_reject_rows_wider_than_1024():
    need_card()
    t = tiles(4, 1025, seed=0, device="cuda")
    with pytest.raises(ValueError):
        ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["none", "lp", "lpp", "bfs_host"])
def test_cuda_engine_matches_cpu_engine(split):
    """Default config on the card: auto picks the tile backend, the
    kernels run, and labels and iteration counts equal the CPU segment
    fit's."""
    need_card()
    ops.reset_launches()
    for g in (graphgen.karate_club()[0], graphgen.erdos_renyi(180, 5.0,
                                                               seed=11),
              graphgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              graphgen.figure1_graph()[0]):
        got = Engine(EngineConfig(split=split), cache=PlanCache()).fit(g)
        want = Engine(EngineConfig(split=split, device="cpu",
                                   backend="segment"),
                      cache=PlanCache()).fit(g)
        assert got.backend == "tile" and got.device.startswith("cuda")
        assert np.array_equal(got.labels, want.labels)
        assert (got.lpa_iterations, got.split_iterations) == \
            (want.lpa_iterations, want.split_iterations)
    assert ops.LAUNCHES["fused_move"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    # (b, sq, h, k, hd, skv, causal)
    (1, 256, 4, 4, 64, 256, True),
    (2, 512, 8, 2, 64, 512, False),
    (1, 512, 4, 1, 128, 512, True),
    (1, 300, 4, 4, 64, 300, True),        # ragged, one partial tile
    (1, 256, 4, 4, 64, 512, False),       # cross: Sq < Skv
    (1, 300, 2, 2, 64, 200, True),        # causal with Sq > Skv
    (2, 1, 4, 2, 128, 77, False),         # one query
    (2, 300, 8, 2, 128, 333, True),       # B=2, ragged Skv: no batch overrun
    (1, 1000, 4, 1, 128, 1000, True),     # several partial KV tiles
    (1, 512, 4, 1, 64, 512, False),       # 128-byte rows
])
def test_cuda_flash_attention_matches_plain_version(shape, dtype):
    """The kernel against ``ref.flash_attention_ref`` on the card, relative
    error 8e-3 in bf16 (one bf16 ulp) and 1e-5 in float32 with TF32 off."""
    need_card()
    b, sq, h, k, hd, skv, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(sq * 31 + skv)
    q = torch.randn((b, sq, h, hd), device="cuda", generator=gen).to(dtype)
    kk = torch.randn((b, skv, k, hd), device="cuda", generator=gen).to(dtype)
    v = torch.randn((b, skv, k, hd), device="cuda", generator=gen).to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ref.flash_attention_ref(q, kk, v, causal).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, kk, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err < (8e-3 if dtype == torch.bfloat16 else 1e-5), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,kv_len,rows,hd", [(4, 513, 1024, 128),
                                              (2, 300, 1024, 128),
                                              (1, 77, 200, 64),
                                              (2, 1, 128, 128)])
def test_cuda_flash_attention_kv_len_reads_only_the_visible_keys(
        b, kv_len, rows, hd, dtype):
    """A decode step's call: one query over the first ``kv_len`` rows of a
    cache whose other rows hold junk; equal to the plain version with
    ``kv_len`` and to the copied-out keys alone."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(kv_len)
    q = torch.randn((b, 1, 8, hd), device="cuda", generator=gen).to(dtype)
    kc, vc = (torch.randn((b, rows, 2, hd), device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    kc[:, kv_len:], vc[:, kv_len:] = 1e4, -1e4
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ref.flash_attention_ref(q, kc, vc, False, kv_len).float()
        alone = ref.flash_attention_ref(
            q, kc[:, :kv_len].contiguous(), vc[:, :kv_len].contiguous(),
            False).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, kc, vc, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for w in (want, alone):
        err = float((got.float() - w).abs().max() / w.abs().max())
        assert err < tol, err
    with pytest.raises(ValueError):
        ops.flash_attention(q, kc, vc, causal=False, kv_len=rows + 1)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_cuda_lm_serve_matches_cpu():
    """serve() of reduced Yi-9B on the card: every attention call in B5
    (2 layers x (1 prefill + 7 decode steps)); its prefill and decode
    logits against the CPU's plain path on the same weights; then
    reduced starcoder2-15b (its window cut to 8, so the prompt and the
    decode pass it) and qwen1.5-32b (its int8 cache) the same way, every
    attention call in B5 with the window or the int8 cache."""
    need_card()
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    cfg = reduced_config("yi-9b")
    cpu = init_from_specs(T.model_specs(cfg), 3, device="cpu")
    card = _tree_to(cpu, "cuda")
    ops.reset_launches()
    out = serve("yi-9b", batch=2, prompt_len=24, max_new=8, s_max=64,
                seed=3, params=card, device="cuda")
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers * 8
    assert out["generated"].shape == (2, 8)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 28)).astype(np.int32))
    def card_vs_cpu(cfg, cpu, card):
        logits = []
        for params, dev in ((cpu, "cpu"), (card, "cuda")):
            t = toks.to(dev)
            with torch.inference_mode():
                lg, caches = T.prefill(cfg, params, {"tokens": t[:, :24]},
                                       64)
                seq = [lg]
                for i in range(24, 28):
                    lg, caches = T.decode_step(cfg, params, caches,
                                               {"tokens": t[:, i:i + 1]})
                    seq.append(lg[:, 0])
            logits.append([x.float().cpu()[..., :cfg.vocab] for x in seq])
        for want, got in zip(*logits):
            assert float((want - got).abs().max() / want.abs().max()) \
                < 0.02
    card_vs_cpu(cfg, cpu, card)
    for arch, kw in (("starcoder2-15b", {"window": 8}), ("qwen1.5-32b", {})):
        c = dataclasses.replace(reduced_config(arch), **kw)
        cpu = init_from_specs(T.model_specs(c), 3, device="cpu")
        ops.reset_launches()
        card_vs_cpu(c, cpu, _tree_to(cpu, "cuda"))
        assert ops.LAUNCHES["flash_attention"] == c.n_layers * 5


def _b5_calls(cfg, prefill: bool) -> int:
    """B5 launches of one prefill or decode step: every self-attention
    layer, plus the encoder's layers (prefill) and the cross attention of
    every decoder layer (encoder-decoder)."""
    n = sum(1 for mix, _ in cfg.layer_kinds() if mix == "attn")
    if cfg.kind != "encdec":
        return n
    return 2 * n + (cfg.enc_layers if prefill else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "rwkv6-7b", "seamless-m4t-large-v2",
                                  "internvl2-26b", "arctic-480b"])
def test_cuda_lm_family_matches_cpu(arch):
    """One family at reduced_config: prefill and one decode step on the
    card against the CPU's plain path on the same weights (0.02), every
    attention, encoder and cross-attention call in B5."""
    need_card()
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs
    cfg = reduced_config(arch)
    cpu = init_from_specs(T.model_specs(cfg), 4, device="cpu")
    card = _tree_to(cpu, "cuda")
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.frontend_len, cfg.d_model))).to(torch.bfloat16)
    if cfg.kind == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, 32, cfg.d_model))).to(torch.bfloat16)
    logits, launches = [], []
    for params, dev in ((cpu, "cpu"), (card, "cuda")):
        b = {k: v.to(dev) for k, v in batch.items()}
        pre = {**b, "tokens": b["tokens"][:, :16]}
        with torch.inference_mode():
            ops.reset_launches()
            lg, caches = T.prefill(cfg, params, pre, 64)
            launches.append(ops.LAUNCHES["flash_attention"])
            ops.reset_launches()
            dec, _ = T.decode_step(cfg, params, caches,
                                   {"tokens": b["tokens"][:, 16:]})
            launches.append(ops.LAUNCHES["flash_attention"])
        logits.append([x.float().cpu()[..., :cfg.vocab]
                       for x in (lg, dec[:, 0])])
    assert launches == [0, 0, _b5_calls(cfg, True), _b5_calls(cfg, False)]
    for want, got in zip(*logits):
        assert bool(torch.isfinite(got).all())
        assert float((want - got).abs().max() / want.abs().max()) < 0.02


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unaligned_rows():
    need_card()
    x = torch.zeros((1, 16 * 2 * 64 + 1), device="cuda",
                    dtype=torch.bfloat16)
    q = x[:, 1:].view(1, 16, 2, 64)
    kv = torch.zeros((1, 16, 1, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("split,shortcut", [("none", False), ("lp", False),
                                            ("lpp", True), ("bfs_host", False)])
@pytest.mark.parametrize("backend,fuse", [("tile", "on"), ("tile", "off"),
                                          ("segment", "auto")])
def test_cuda_fit_many_matches_cpu_fit_many(backend, fuse, split, shortcut):
    """fit_many on the card (the kernels on packed rows for tile) equals the
    CPU's fit_many and the card's solo fits, member by member."""
    need_card()
    graphs = [graphgen.karate_club()[0],
              graphgen.erdos_renyi(180, 5.0, seed=11),
              graphgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              graphgen.figure1_graph()[0],
              graphgen.grid2d(20)]
    cfg = dict(backend=backend, fuse_sweeps=fuse, split=split,
               shortcut=shortcut)
    ops.reset_launches()
    eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    got = eng.fit_many(graphs)
    if backend == "tile":
        name = "fused_move" if fuse == "on" else "label_argmax"
        assert ops.LAUNCHES[name] > 0
    want = Engine(EngineConfig(device="cpu", **cfg),
                  cache=PlanCache()).fit_many(graphs)
    for i, g in enumerate(graphs):
        solo = eng.fit(g)
        for w in (want[i], solo):
            assert np.array_equal(got[i].labels, w.labels), i
            assert (got[i].lpa_iterations, got[i].split_iterations) == \
                (w.lpa_iterations, w.split_iterations), i
        assert got[i].device.startswith("cuda")


@pytest.mark.cuda
def test_cuda_dense_path_and_facades_match():
    """The dense path on the card (B1 / B2 directly) equals the segment
    path; gsl_lpa / gve_lpa on the card equal their CPU runs."""
    need_card()
    from repro_torch.core import dense, gsl_lpa, gve_lpa
    from repro_torch.core.lpa import lpa_run
    from repro_torch.core.split import split_lp
    g = graphgen.erdos_renyi(3000, 8.0, seed=1).to("cuda")
    labels, iters = dense.lpa_run_dense(dense.pad_graph(g, rows=3008))
    sparse = lpa_run(g)
    assert torch.equal(labels, sparse.labels) and iters == sparse.iteration
    sl, si = dense.split_lp_dense(dense.pad_graph(g), labels)
    sp = split_lp(g, labels)
    assert torch.equal(sl, sp.labels) and si == sp.iterations
    karate = graphgen.karate_club()[0]
    for fn in (gsl_lpa, gve_lpa):
        a, b = fn(karate), fn(karate, device="cpu")
        assert a.detail.device.startswith("cuda")
        assert np.array_equal(a.labels, b.labels)
        assert (a.lpa_iterations, a.split_iterations) == \
            (b.lpa_iterations, b.split_iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ("tile", "segment"))
def test_cuda_stream_warm_updates_match_cpu(backend):
    """StreamSession on the card (warm, with the frontier) equals the same
    session on the CPU, round for round; the graphs stay on the host."""
    need_card()
    from repro_torch.launch.stream import StreamSession
    tr = [graphgen.evolving_sequence(n, 4.0, 2, 6, seed=50 + i)
          for i, n in enumerate((300, 180))]
    out = {}
    for device in ("cuda", "cpu"):
        eng = Engine(EngineConfig(backend=backend, split="lp",
                                  device=device), cache=PlanCache())
        ops.reset_launches()
        with StreamSession(eng, max_batch=4) as sess:
            sess.add_many({i: b for i, (b, _) in enumerate(tr)})
            out[device] = [sess.update_many({i: ds[r] for i, (_, ds)
                                             in enumerate(tr)})
                           for r in range(2)]
            assert all(sess.graph(i).device.type == "cpu" for i in (0, 1))
        if device == "cuda" and backend == "tile":
            assert ops.LAUNCHES["fused_move"] > 0
    for got, want in zip(out["cuda"], out["cpu"]):
        for i in (0, 1):
            assert got[i].warm_started and got[i].device.startswith("cuda")
            assert np.array_equal(got[i].labels, want[i].labels)
            assert (got[i].lpa_iterations, got[i].split_iterations) == \
                (want[i].lpa_iterations, want[i].split_iterations)


@pytest.mark.cuda
def test_cuda_fit_of_a_graph_file_matches_cpu(tmp_path, monkeypatch):
    """Engine().fit(path) on the card equals the CPU fit of the same file,
    and a second fit under warm_start="auto" is warm."""
    need_card()
    from repro_torch.core.delta import undirected_edges
    from repro_torch.io import write_mtx
    monkeypatch.setenv("REPRO_GRAPH_CACHE", str(tmp_path / "store"))
    g = graphgen.grid2d(40)
    path = tmp_path / "grid.mtx"
    write_mtx(path, undirected_edges(g)[0], n=g.n, symmetric=True)
    eng = Engine(EngineConfig(warm_start="auto"), cache=PlanCache())
    got = eng.fit(str(path))
    want = Engine(EngineConfig(device="cpu"), cache=PlanCache()).fit(g)
    assert got.device.startswith("cuda") and not got.warm_started
    assert np.array_equal(got.labels, want.labels)
    assert eng.fit(str(path)).warm_started


def _same_profile(a, b) -> bool:
    phases = [(a.propagation, b.propagation), (a.split, b.split)]
    return a.n == b.n and all(
        (x is None) == (y is None) and (x is None or all(
            np.array_equal(getattr(x, f), getattr(y, f))
            for f in ("sweep", "active", "changed")))
        for x, y in phases)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["none", "lp", "lpp"])
@pytest.mark.parametrize("backend,fuse", [("tile", "on"), ("tile", "off"),
                                          ("segment", "auto")])
def test_cuda_profiled_fit_equals_unprofiled_fit(backend, fuse, split):
    """profile="full" on the card, the hand kernels in the loop: the labels
    and both iteration counts of the unprofiled fit, solo and batched."""
    need_card()
    graphs = [graphgen.karate_club()[0],
              graphgen.erdos_renyi(180, 5.0, seed=11),
              graphgen.figure1_graph()[0], graphgen.grid2d(20)]
    cfg = dict(backend=backend, fuse_sweeps=fuse, split=split)
    ops.reset_launches()
    prof = Engine(EngineConfig(profile="full", **cfg), cache=PlanCache())
    base = Engine(EngineConfig(**cfg), cache=PlanCache())
    got_many = prof.fit_many(graphs)
    want_many = base.fit_many(graphs)
    for i, g in enumerate(graphs):
        got, want = prof.fit(g), base.fit(g)
        for a, b in ((got, want), (got_many[i], want_many[i])):
            assert np.array_equal(a.labels, b.labels), i
            assert (a.lpa_iterations, a.split_iterations) == \
                (b.lpa_iterations, b.split_iterations), i
            assert b.profile is None
            assert a.profile.propagation.num_sub_sweeps \
                == 2 * a.lpa_iterations
        assert _same_profile(got.profile, got_many[i].profile), i
    if backend == "tile":
        assert ops.LAUNCHES["fused_move" if fuse == "on"
                            else "label_argmax"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["lp", "lpp"])
@pytest.mark.parametrize("backend,fuse", [("tile", "on"), ("tile", "off"),
                                          ("segment", "auto")])
def test_cuda_profile_equals_cpu_profile(backend, fuse, split):
    """The card's convergence curves equal the CPU's on the same graphs
    and the same backend, solo and batched."""
    need_card()
    graphs = [graphgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              graphgen.erdos_renyi(300, 6.0, seed=2), graphgen.grid2d(24)]
    cfg = dict(backend=backend, fuse_sweeps=fuse, split=split,
               profile="full")
    card = Engine(EngineConfig(**cfg), cache=PlanCache())
    host = Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache())
    many_card, many_host = card.fit_many(graphs), host.fit_many(graphs)
    for i, g in enumerate(graphs):
        a, b = card.fit(g), host.fit(g)
        assert a.device.startswith("cuda") and b.device == "cpu"
        assert _same_profile(a.profile, b.profile), i
        assert _same_profile(many_card[i].profile, many_host[i].profile), i


def _ooc_budget(g) -> int:
    """Half the in-core edge bytes: the tile fit must partition."""
    from repro_torch.partition.ooc import IN_CORE_EDGE_BYTES
    return g.m_pad * IN_CORE_EDGE_BYTES // 2


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["lp", "lpp"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_cuda_ooc_tile_fit_matches_cpu_in_core(fuse, split):
    """An out-of-core tile fit on the card: B3 / B4 (fused) or B1 / B2
    (unfused) once per partition visit, on tiles whose label vectors run
    past their rows into the halo, with the labels and iteration counts
    of the CPU's in-core fit and the peak within the budget."""
    need_card()
    from repro_torch.partition.ooc import fit_out_of_core, open_source
    for g in (graphgen.grid2d(40), graphgen.erdos_renyi(300, 6.0, seed=2),
              graphgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0]):
        budget = _ooc_budget(g)
        cfg = dict(backend="tile", fuse_sweeps=fuse, split=split)
        want = Engine(EngineConfig(device="cpu", **cfg),
                      cache=PlanCache()).fit(g)
        ops.reset_launches()
        run = fit_out_of_core(open_source(g), EngineConfig(**cfg),
                              memory_budget=budget)
        launches = dict(ops.LAUNCHES)
        got = Engine(EngineConfig(**cfg), cache=PlanCache()).fit(
            g, memory_budget=budget)
        assert run.num_partitions > 1 and got.partitions > 1
        assert got.device.startswith("cuda")
        assert np.array_equal(got.labels, want.labels)
        assert (got.lpa_iterations, got.split_iterations) == \
            (want.lpa_iterations, want.split_iterations)
        assert run.peak_resident_bytes <= budget
        assert got.ooc["peak_resident_bytes"] <= budget
        move, split_k = (("fused_move", "fused_split") if fuse == "on"
                         else ("label_argmax", "min_label"))
        p = run.num_partitions
        assert launches[move] == p * 2 * run.lpa_iterations
        assert launches[split_k] == p * run.split_iterations


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_cuda_ooc_prefetch_on_and_off_agree(fuse):
    """The prefetch worker uploads on a stream of its own; with it on and
    off (and the label caches on and off) the labels are identical, and a
    budget with room for a staged window is used."""
    need_card()
    from repro_torch.partition.ooc import fit_out_of_core, open_source
    g = graphgen.grid2d(60)
    source = open_source(g)
    cfg = EngineConfig(backend="tile", fuse_sweeps=fuse, split="lpp")
    runs = [fit_out_of_core(source, cfg, memory_budget=budget,
                            num_partitions=6, prefetch=prefetch,
                            halo_cache=cache)
            for budget in (_ooc_budget(g), 4 * _ooc_budget(g))
            for prefetch in (False, True) for cache in (False, True)]
    for r in runs[1:]:
        assert np.array_equal(r.labels, runs[0].labels)
        assert (r.lpa_iterations, r.split_iterations) == \
            (runs[0].lpa_iterations, runs[0].split_iterations)
    assert all(r.peak_resident_bytes <= r.budget for r in runs)
    assert max(r.prefetch_hits for r in runs) > 0


@pytest.mark.cuda
def test_cuda_kernels_on_partition_vectors_match_plain_versions():
    """B1-B4 on tiles of 64 rows whose labels / comm / chg vectors are
    longer than the tile (owned rows, then a halo), nbr reaching into the
    halo: equal to the plain versions."""
    need_card()
    rng = np.random.default_rng(7)
    rows, d, n_loc = 64, 8, 200
    mask = rng.random((rows, d)) < 0.7
    host = dict(
        nbr=rng.integers(0, n_loc, size=(rows, d)).astype(np.int32),
        nw=rng.integers(1, 4, size=(rows, d)).astype(np.float32),
        nmask=mask,
        labels=rng.integers(0, 10_000, size=n_loc).astype(np.int32),
        comm=rng.integers(0, 3, size=n_loc).astype(np.int32),
        chg=rng.random(n_loc) < 0.3, active=rng.random(rows) < 0.6,
        cand_prev=rng.random(rows) < 0.3, klass=rng.random(rows) < 0.5,
        real=np.ones(rows, bool))
    for dev_out in ("cpu", "cuda"):
        t = {k: torch.from_numpy(v).to(dev_out) for k, v in host.items()}
        out = (ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                5),
               ops.min_label(t["nbr"], t["nmask"], t["labels"], t["comm"]),
               ops.fused_move(t["nbr"], t["nw"], t["nmask"], t["labels"],
                              t["chg"], t["active"], t["cand_prev"],
                              t["klass"], t["real"], 5),
               ops.fused_split(t["nbr"], t["nmask"], t["labels"], t["comm"],
                               t["chg"], True))
        if dev_out == "cpu":
            want = out
    flat = [x for o in out for x in (o if isinstance(o, tuple) else (o,))]
    flat_w = [x for o in want for x in (o if isinstance(o, tuple) else (o,))]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(flat, flat_w))


def _tenant_load(device):
    """K = 4 tenants, one client thread (deterministic), tile backend."""
    from repro_torch.serve import ServiceConfig, TenantService
    from repro_torch.serve.loadgen import LoadConfig, build_traces, run_load
    cfg = LoadConfig(tenants=4, rounds=3, size=400, delta_edges=6,
                     refresh_every=3, parity_tenants=2, client_threads=1,
                     seed=5)
    svc = TenantService(
        Engine(EngineConfig(device=device, backend="tile", quality="full"),
               cache=PlanCache()),
        ServiceConfig(queue_capacity=8, max_batch=4, warm_budget=4000))
    try:
        records, summary = run_load(svc, build_traces(cfg), cfg)
        final = {t: svc.labels(t) for t in svc.tenants()}
    finally:
        svc.close()
    return records, summary, final


@pytest.mark.cuda
def test_cuda_tenant_service_matches_cpu():
    """The serving tier on the card (B3 / B4 on every batch) gives the CPU
    run's labels, iteration counts, spills and health samples."""
    need_card()
    ops.reset_launches()
    recs, summary, final = _tenant_load(None)
    assert ops.LAUNCHES["fused_move"] > 0 and ops.LAUNCHES["fused_split"] > 0
    crecs, csummary, cfinal = _tenant_load("cpu")
    assert summary["stranded"] == 0 and summary["failed"] == 0
    for k in ("requests", "completed", "spills", "warm_bytes_peak"):
        assert summary[k] == csummary[k], k
    key = [(r["tenant"], r["kind"], r.get("lpa_iterations"),
            r.get("warm_started")) for r in recs]
    assert key == [(r["tenant"], r["kind"], r.get("lpa_iterations"),
                    r.get("warm_started")) for r in crecs]
    assert set(final) == set(cfinal)
    for t in final:
        assert (final[t] is None) == (cfinal[t] is None), t
        if final[t] is not None:
            assert np.array_equal(final[t], cfinal[t]), t


@pytest.mark.cuda
def test_cuda_one_rank_nccl_sharded_fit_matches_tile(tmp_path):
    """A one-rank NCCL group (file store) and a one-rank CUDA DeviceMesh:
    the sharded fit launches B1 twice per LPA step and B2 once per split
    sweep, with the tile fit's labels and iteration counts."""
    need_card()
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    g = graphgen.planted_partition(8, 200, 0.05, 0.002, seed=4)[0]
    want = Engine(EngineConfig(backend="tile"), cache=PlanCache()).fit(g)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = DeviceMesh("cuda", [0])
        ops.reset_launches()
        got = Engine(EngineConfig(backend="sharded", mesh=mesh),
                     cache=PlanCache()).fit(g)
        launches = dict(ops.LAUNCHES)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got.labels, want.labels)
    assert (got.lpa_iterations, got.split_iterations) \
        == (want.lpa_iterations, want.split_iterations)
    assert launches["label_argmax"] == 2 * got.lpa_iterations
    assert launches["min_label"] == got.split_iterations
    assert launches["fused_move"] == launches["fused_split"] == 0


XENT_SCRIPT = """
import pickle, sys
import numpy as np
import torch


def rank_fn(rank, world, vocabs):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import transformer as T
    from repro_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
    out = {}
    for vocab in vocabs:
        rng = np.random.default_rng(90 + vocab)
        lg = torch.from_numpy((rng.standard_normal((8, 6, vocab)) * 3)
                              .astype(np.float32)).cuda()
        tg = torch.from_numpy(rng.integers(0, vocab, (8, 6))).cuda()
        lg = distribute_tensor(lg, mesh, [Shard(0), Shard(2)],
                               src_data_rank=None).requires_grad_(True)
        tg = distribute_tensor(tg, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        loss = T._mean_xent(lg, tg)
        loss.backward()
        out[vocab] = (float(loss), lg.grad.full_tensor().cpu().numpy())
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(rank_fn, 4, ((20, 21),), backend="gloo", timeout=240)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
"""


@pytest.mark.cuda
def test_cuda_gloo_mesh_cross_entropy_matches_plain(tmp_path):
    """The train loss's vocab-sharded cross-entropy on a (2, 2) mesh of
    four gloo ranks sharing the card (the chip check's layout), value and
    gradient against plain PyTorch on the CPU, float32.  The same sums
    written as DTensor operations gave wrong gradients on this mesh under
    torch 2.11 while the loss was right."""
    need_card()
    script = tmp_path / "xent.py"
    script.write_text(XENT_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(script),
                           str(tmp_path / "out.pkl")], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import pickle
    with open(tmp_path / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    for vocab in (20, 21):
        rng = np.random.default_rng(90 + vocab)
        lg = torch.from_numpy((rng.standard_normal((8, 6, vocab)) * 3)
                              .astype(np.float32)).requires_grad_(True)
        tg = torch.from_numpy(rng.integers(0, vocab, (8, 6)))
        gold = torch.gather(lg, -1, tg[..., None])[..., 0]
        want = torch.mean(torch.logsumexp(lg, dim=-1) - gold)
        want.backward()
        wgrad = lg.grad.numpy()
        for r in ranks:
            loss, grad = r[vocab]
            np.testing.assert_allclose(loss, float(want.detach()),
                                       rtol=1e-5)
            np.testing.assert_allclose(grad, wgrad, rtol=0,
                                       atol=1e-5 * np.abs(wgrad).max())


STEP_SCRIPT = """
import dataclasses, pickle, sys
import numpy as np
import torch

ARCHS = ("yi-9b", "qwen2-moe-a2.7b")


def setup(arch):
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs, map_specs
    cfg = reduced_config(arch)
    specs = map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32),
                      T.model_specs(cfg))
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    return cfg, init_from_specs(specs, 3, device="cpu"), batch


def rank_fn(rank, world):
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import make_mesh
    from repro_torch.train import steps as TS
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
    out = {}
    for arch in ARCHS:
        cfg, params, batch = setup(arch)
        step, _, psh, osh = TS.make_train_step(cfg, mesh, "train_4k",
                                               donate=False, keep_grads=True)
        p = TS.shard_tree(tree_map(lambda x: x.cuda(), params), psh)
        opt = TS.init_opt_state(cfg, p, osh)
        _, _, m = step(p, opt, {k: v.cuda() for k, v in batch.items()}, 5)
        g = TS.gather_tree(m["grads"])
        out[arch] = (float(m["loss"]),
                     [x.cpu().numpy() for x in tree_leaves(g)])
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(rank_fn, 4, (), backend="gloo", timeout=240)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
"""


@pytest.mark.cuda
def test_cuda_gloo_mesh_train_step_grads_match_one_process(tmp_path):
    """The sharded train step's gradients on a (2, 2) mesh of four gloo
    ranks sharing the card (tensor parallel over ``model``, ZeRO-1 over
    ``data``) against one process on the card under the same rules on an
    abstract mesh (the MoE then dispatches per data shard alike), reduced
    yi-9b and qwen2-moe in float32: the loss within 1e-5, every gradient
    leaf within 1e-4 of its largest entry."""
    need_card()
    import pickle

    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import abstract_mesh, make_rules, use_rules
    from repro_torch.train import steps as TS
    script = tmp_path / "step.py"
    script.write_text(STEP_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(script),
                           str(tmp_path / "out.pkl")], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    ns = {}
    exec(STEP_SCRIPT.split("def rank_fn")[0], ns)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = abstract_mesh((2, 2), ("data", "model"))
    for arch in ns["ARCHS"]:
        cfg, params, batch = ns["setup"](arch)
        with use_rules(make_rules(mesh, cfg, "train_4k")):
            loss, g = TS._loss_and_grads(
                cfg, tree_map(lambda x: x.cuda(), params),
                {k: v.cuda() for k, v in batch.items()})
        want = [x.cpu().numpy() for x in tree_leaves(g)]
        for r in ranks:
            got_loss, got = r[arch]
            np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-30))


def bwd_inputs(shape, dtype, seed, window=None):
    """q, k, v, dout from a seed, and B5's out and lse for them (under
    ``window``, if given)."""
    b, sq, h, k, hd, skv, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, kk, v, do = (torch.randn(s, device="cuda", generator=gen).to(dtype)
                    for s in ((b, sq, h, hd), (b, skv, k, hd),
                              (b, skv, k, hd), (b, sq, h, hd)))
    out, lse = ops.flash_attention_fwd(q, kk, v, causal, window=window)
    return q, kk, v, out, do, lse, causal


def rel_err(got, want):
    """Max abs difference over the plain version's max abs; the difference
    itself where the plain version is all zeros (dq and dk over one key,
    where softmax has no gradient)."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return diff / scale if scale > 0 else diff


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    # (b, sq, h, k, hd, skv, causal)
    (2, 512, 32, 4, 128, 512, True),          # Yi's heads, G = 8
    (2, 300, 4, 4, 64, 200, False),           # ragged, cross, G = 1
    # the bf16 kernel's tiles (64 query rows, 128 keys): a partial last
    # query and KV tile at G = 8, more queries than keys, one key
    (2, 129, 16, 2, 128, 129, True),
    (2, 191, 16, 2, 128, 191, True),
    (2, 200, 8, 2, 128, 130, True),
    (2, 100, 8, 2, 64, 1, False),
    (4, 4096, 32, 4, 128, 4096, True),        # the trainer's call
])
def test_cuda_flash_attention_bwd_matches_plain_version(shape, dtype):
    """B5-bwd against autograd through the plain version: dq, dk, dv
    within 1e-4 (float32, TF32 off) / 2e-2 (bf16), relative; two
    launches give the same bits."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kk, v, out, do, lse, causal = bwd_inputs(shape, dtype, 11)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal)
    again = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    want = ref.flash_attention_bwd_ref(q, kk, v, do, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        err = rel_err(g, w)
        assert err < tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,window", [
    # (b, sq, h, k, hd, skv, causal), window: bands narrower than a KV
    # tile (128 keys) and a query tile (64 rows), one not a multiple of
    # either, the diagonal alone, one wider than the sequence, non-causal
    # with more keys than queries, and starcoder2-15b's heads
    ((2, 300, 8, 2, 128, 300, True), 64),
    ((2, 191, 16, 2, 128, 191, True), 100),
    ((2, 517, 12, 2, 64, 517, True), 130),
    ((2, 256, 4, 4, 64, 256, True), 1),
    ((1, 1024, 8, 1, 128, 1024, True), 2000),
    ((2, 200, 4, 4, 64, 300, False), 50),
    ((1, 2048, 48, 4, 128, 2048, True), 512),
])
def test_cuda_flash_attention_bwd_window_matches_plain_version(
        shape, window, dtype):
    """B5-bwd under a sliding window against autograd through the plain
    version with that window: dq, dk, dv within 1e-4 (float32, TF32 off)
    / 2e-2 (bf16), relative; two launches give the same bits; and
    ops.flash_attention with the window under grad launches B5-bwd."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kk, v, out, do, lse, causal = bwd_inputs(shape, dtype, 17, window)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal,
                                  window=window)
    again = ops.flash_attention_bwd(q, kk, v, out, do, lse, causal,
                                    window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    want = ref.flash_attention_bwd_ref(q, kk, v, do, causal, window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        err = rel_err(g, w)
        assert err < tol, err
    leaves = [x.detach().requires_grad_(True) for x in (q, kk, v)]
    ops.flash_attention(*leaves, causal=causal, window=window).backward(do)
    assert ops.LAUNCHES["flash_attention_bwd"] == 3
    for t, g in zip(leaves, got):
        assert torch.equal(t.grad, g)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_carries_nothing_between_calls():
    """Two bf16 shapes back to back, then the first again: the same bits
    as its first call (the workspace and the tickets are the call's
    own)."""
    need_card()
    first = bwd_inputs((2, 191, 16, 2, 128, 191, True), torch.bfloat16, 13)
    second = bwd_inputs((4, 512, 32, 4, 128, 512, True), torch.bfloat16, 14)
    a = ops.flash_attention_bwd(*first)
    ops.flash_attention_bwd(*second)
    b = ops.flash_attention_bwd(*first)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_flash_attention_grad_goes_through_b5_bwd():
    """Under grad on the card, ops.flash_attention is B5 with lse and its
    backward B5-bwd: nonzero q, k and v gradients equal to the plain
    version's; kv_len < Skv under grad raises."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, kk, v = (torch.randn(s, device="cuda", generator=gen).bfloat16()
                .requires_grad_(True)
                for s in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    do = torch.randn((2, 256, 8, 64), device="cuda", generator=gen).bfloat16()
    ops.reset_launches()
    out = ops.flash_attention(q, kk, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q.detach(), kk.detach(), v.detach(),
                                       do, True)
    for t, w in zip((q, kk, v), want):
        assert t.grad is not None and float(t.grad.float().abs().max()) > 0
        err = float((t.grad.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err < 2e-2, err
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, kk, v, causal=False, kv_len=100)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """One make_train_step step of reduced Yi-9B (hd 64) on the card
    against the CPU in float32 (TF32 off): the loss within 1e-5, the
    grad norm within 1e-4; B5 and B5-bwd launched once per layer."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs, map_specs
    from repro_torch.train import steps as S
    cfg = reduced_config("yi-9b")
    specs = map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32),
                      T.model_specs(cfg))
    cpu = init_from_specs(specs, 4, device="cpu")
    host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=4,
                              seed=4).next_batch()
    step, *_ = S.make_train_step(cfg, None, "train_4k", donate=False)
    out = {}
    for dev in ("cpu", "cuda"):
        params = _tree_to(cpu, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        ops.reset_launches()
        _, _, m = step(params, S.init_opt_state(cfg, params), batch, 10)
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
        if dev == "cuda":
            assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
            assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-5 * l0 and abs(g1 - g0) <= 1e-4 * g0


def test_port_import_pulls_in_no_jax():
    """Importing the whole port loads neither JAX nor the JAX package."""
    code = ("import sys; import repro_torch.engine, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.graphgen, "
            "repro_torch.models.attention, repro_torch.io, "
            "repro_torch.launch.stream, repro_torch.launch.ingest, "
            "repro_torch.obs, repro_torch.launch.obs, "
            "repro_torch.partition, repro_torch.serve, "
            "repro_torch.checkpoint, repro_torch.launch.serve, "
            "repro_torch.launch.mesh, repro_torch.core.distributed, "
            "repro_torch.core.baselines, repro_torch.core.metrics, "
            "repro_torch.configs, repro_torch.models.transformer, "
            "repro_torch.models.convert, repro_torch.data.clustering, "
            "repro_torch.data.pipeline, repro_torch.optim, "
            "repro_torch.optim.compress, repro_torch.train, repro_torch.ft, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # (b, sq, h, k, hd, rows, kv_len, q_offset, window, int8)
    (2, 300, 4, 2, 128, 300, 300, 0, 64, False),     # window prefill
    (1, 1000, 8, 2, 64, 1000, 1000, 0, 129, False),
    (2, 1, 8, 2, 128, 700, 650, 649, 100, False),     # window decode
    (3, 1, 4, 4, 128, 700, 650, 649, None, True),     # int8 decode
    (2, 1, 8, 2, 64, 700, 399, 398, 129, True),       # int8 + window
    (1, 1, 4, 2, 128, 256, 256, 300, 100, True),      # an SP rank, rows
])                                                    # before the query
def test_cuda_flash_attention_window_and_int8_match_plain(case, dtype):
    """B5 with a sliding window and with an int8 cache (bf16 scales,
    ``quantize_kv``) against its plain version on the same inputs, out
    and lse; the rows past kv_len hold junk that must not be read."""
    need_card()
    from repro_torch.models.attention import quantize_kv
    b, sq, h, k, hd, rows, kv_len, q_off, window, q8 = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case[:7]))
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    kc, vc = (torch.randn(b, rows, k, hd, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    kc[:, kv_len:] = 1e4
    ks = vs = None
    if q8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    kw = dict(causal=True, kv_len=kv_len, window=window, q_offset=q_off,
              k_scale=ks, v_scale=vs)
    before = ops.LAUNCHES["flash_attention"]
    out, lse = ops.flash_attention_fwd(q, kc, vc, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    cpu = {n: (t.cpu() if torch.is_tensor(t) else t) for n, t in kw.items()}
    want = ref.flash_attention_ref(q.cpu(), kc.cpu(), vc.cpu(),
                                   cpu.pop("causal"), cpu.pop("kv_len"),
                                   **cpu)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert rel_err(out.cpu(), want) < tol
    wl = ref.attention_lse_ref(q.cpu(), kc.cpu(), True, kv_len,
                               window=window, q_offset=q_off,
                               k_scale=None if ks is None else ks.cpu())
    assert float((lse.cpu() - wl).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q8", [False, True])
def test_cuda_flash_attention_counts_rows_loaded(dtype, q8):
    """``ops.count_kv_rows``: a bf16 window decode (the decode body) loads
    each visible 64-key tile, from the one that holds the oldest visible
    key up to kv_len, once per (batch, KV head), its blocks the spans of
    ``ref.decode_split``; in float32 each block (one per query head)
    loads those tiles of 64 keys whole; each block of a causal prefill
    the tiles up to its last row's diagonal (tiles of 128 keys in the
    bf16 body, 64 in float32's, as tall as its query tiles); the output
    bit-equal to a launch that counts nothing."""
    need_card()
    from repro_torch.models.attention import quantize_kv
    bk = 128 if dtype == torch.bfloat16 else 64
    b, h, k, hd, rows, kv_len, window = 2, 8, 2, 128, 1000, 900, 300
    gen = torch.Generator(device="cuda").manual_seed(5)
    kc, vc = (torch.randn(b, rows, k, hd, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    ks = vs = None
    if q8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    q = torch.randn(b, 1, h, hd, device="cuda", generator=gen).to(dtype)
    kw = dict(causal=True, kv_len=kv_len, window=window,
              q_offset=kv_len - 1, k_scale=ks, v_scale=vs)
    plain = ops.flash_attention(q, kc, vc, **kw)
    with ops.count_kv_rows() as got:
        out = ops.flash_attention(q, kc, vc, **kw)
    assert torch.equal(out, plain)
    assert len(got) == 1
    if dtype == torch.bfloat16:
        split = ref.decode_split(b, h, k, kv_len, True, window, kv_len - 1)
        spans = [min(e, kv_len) - a for a, e in split.spans()]
        assert sum(spans) == kv_len - (kv_len - window) // 64 * 64
        assert (got[0]["blocks"], got[0]["max_rows"], got[0]["rows"]) == (
            b * k * split.splits, max(spans), b * k * sum(spans))
    else:
        per_block = kv_len - (kv_len - window) // bk * bk
        assert (got[0]["blocks"], got[0]["max_rows"], got[0]["rows"]) == (
            b * h, per_block, b * h * per_block)
    # a causal prefill of sq rows over its own keys
    sq = 300
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    kp, vp = kc[:, :sq].contiguous(), vc[:, :sq].contiguous()
    sc = {} if not q8 else dict(k_scale=ks[:, :sq].contiguous(),
                                v_scale=vs[:, :sq].contiguous())
    with ops.count_kv_rows() as got:
        ops.flash_attention(q, kp, vp, causal=True, **sc)
    tiles = -(-sq // bk)
    want = [min((t + 1) * bk, sq) for t in range(tiles)]
    assert (got[0]["blocks"], got[0]["max_rows"], got[0]["rows"]) == (
        b * h * tiles, sq, b * h * sum(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (b, h, k, hd, rows, kv_len, q_offset, window, causal, int8)
    (4, 32, 4, 128, 1024, 513, 512, None, False, False),   # Yi-9B's step
    (2, 48, 4, 128, 8192, 6176, 6175, 4096, False, False), # starcoder2-15b
    (4, 48, 8, 128, 2048, 1537, 1536, None, False, False), # G = 6
    (4, 16, 16, 64, 1024, 513, 512, None, False, False),   # hd 64, G = 1
    (4, 16, 16, 64, 32, 32, 0, None, False, False),        # cross decode
    (2, 24, 24, 128, 4096, 2080, 2079, None, True, True),  # int8 cache
    (2, 16, 2, 64, 700, 399, 398, 129, True, True),        # int8 + window
    (1, 16, 4, 128, 256, 256, 300, 100, True, False),      # an SP rank
    (1, 20, 1, 64, 300, 290, 289, None, False, False),     # 2 row chunks
    (3, 8, 2, 128, 64, 1, 0, None, True, False),           # one key
])
def test_cuda_decode_body_matches_plain(case):
    """B5's decode body (every bf16 call with one query row) against its
    plain version ``ref.flash_decode_ref`` (the same split, float32) and
    the chunked oracle, 8e-3 relative; lse within 1e-3; two launches
    bit-equal, each counted once under flash_attention and flash_decode;
    the key rows its blocks load those of the visible tiles, once per
    (batch, KV head, row chunk)."""
    need_card()
    from repro_torch.models.attention import quantize_kv
    b, h, k, hd, rows, kv_len, q_off, window, causal, q8 = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case[:7]))
    q = torch.randn(b, 1, h, hd, device="cuda", generator=gen).bfloat16()
    kc, vc = (torch.randn(b, rows, k, hd, device="cuda", generator=gen)
              .bfloat16() for _ in range(2))
    kc[:, kv_len:] = 1e4
    ks = vs = None
    if q8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    kw = dict(causal=causal, kv_len=kv_len, window=window, q_offset=q_off,
              k_scale=ks, v_scale=vs)
    before = dict(ops.LAUNCHES)
    out, lse = ops.flash_attention_fwd(q, kc, vc, **kw)
    again = ops.flash_attention(q, kc, vc, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode"] == before["flash_decode"] + 2
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert torch.equal(out, again)
    want, want_lse = ref.flash_decode_ref(q, kc, vc, **kw)
    assert rel_err(out, want) < 8e-3
    assert rel_err(out, ref.flash_attention_ref(q, kc, vc, **kw)) < 8e-3
    assert float((lse - want_lse).abs().max()) < 1e-3
    with ops.count_kv_rows() as got:
        assert torch.equal(ops.flash_attention(q, kc, vc, **kw), out)
    split = ref.decode_split(b, h, k, kv_len, causal, window, q_off)
    chunks = -(-(h // k) // ref.DECODE_ROWS)
    spans = [min(e, kv_len) - a for a, e in split.spans()]
    n = b * k * chunks
    assert (got[0]["blocks"], got[0]["max_rows"], got[0]["rows"]) == (
        n * split.splits, max(spans), n * sum(spans))


SERVE_MESH_SCRIPT = """
import dataclasses, pickle, sys
import numpy as np
import torch

# (arch, cell, batch, mesh, KV cache dtype): yi-9b on (1, 4) is layout
# (b), its 2 KV heads not dividing 4 (head_dim over model)
CASES = (("yi-9b", "decode_32k", 4, (2, 2), None),
         ("yi-9b", "decode_32k", 4, (1, 4), None),
         ("yi-9b", "decode_32k", 4, (1, 4), "int8"),
         ("qwen1.5-32b", "decode_32k", 4, (2, 2), None),
         ("jamba-v0.1-52b", "long_500k", 1, (2, 2), None))


def setup(arch, batch, kv_dtype):
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs, map_specs
    cfg = reduced_config(arch)
    if kv_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    specs = map_specs(lambda s: dataclasses.replace(s, dtype=torch.float32),
                      T.model_specs(cfg))
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 20))
                           .astype(np.int32))
    return cfg, init_from_specs(specs, 3, device="cpu"), tok


def run(cfg, params, tok, mesh, shape):
    from repro_torch.kernels import ops
    from repro_torch.train import steps as TS
    pre, _, psh, _ = TS.make_prefill_step(cfg, mesh, shape, s_max=32)
    dec, *_ = TS.make_decode_step(cfg, mesh, shape)
    if psh is not None:
        params = TS.shard_tree(params, psh)
    ops.reset_launches()
    lg, caches = pre(params, {"tokens": tok[:, :12]})
    out = [lg.float().cpu().numpy()]
    for t in range(12, 20):
        lg, caches = dec(params, caches, {"tokens": tok[:, t:t + 1]})
        out.append(lg[:, 0].float().cpu().numpy())
    return out, ops.LAUNCHES["flash_attention"]


def rank_fn(rank, world):
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    out = {}
    for arch, shape, batch, mshape, kv_dtype in CASES:
        mesh = make_mesh(mshape, ("data", "model"), device_type="cuda")
        cfg, params, tok = setup(arch, batch, kv_dtype)
        out[arch, mshape, kv_dtype] = run(
            cfg, tree_map(lambda x: x.cuda(), params), tok.cuda(), mesh,
            shape)
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(rank_fn, 4, (), backend="gloo", timeout=240)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
"""


@pytest.mark.cuda
def test_cuda_gloo_mesh_decode_matches_one_process(tmp_path):
    """Serving on a mesh of four gloo ranks sharing the card: reduced
    yi-9b on (2, 2) (layout (a), batch over data, KV heads over model)
    and on (1, 4) (layout (b), head_dim over model, the visible rows of
    each rank's KV heads made whole by an all-to-all before each B5
    call), there with a bf16 and an int8 cache, and on (2, 2)
    qwen1.5-32b (layout (a) with its int8 cache) and jamba-v0.1-52b
    under long_500k (layout (c), the 32-row cache's rows over data, the
    decode crossing into rank 1's) in float32, a 12-token prefill and 8
    decode steps, against one process on the card: every step's logits
    within 1e-4 of the largest, every rank identical, B5 launched on
    every rank.  It guards the DTensor path on the card's torch, whose
    DTensor has differed from the CPU's."""
    need_card()
    import pickle

    from repro_torch.optim.adamw import tree_map
    script = tmp_path / "serve.py"
    script.write_text(SERVE_MESH_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(script),
                           str(tmp_path / "out.pkl")], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    ns = {}
    exec(SERVE_MESH_SCRIPT.split("def rank_fn")[0], ns)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, shape, batch, mshape, kv_dtype in ns["CASES"]:
        key = arch, mshape, kv_dtype
        cfg, params, tok = ns["setup"](arch, batch, kv_dtype)
        want, _ = ns["run"](cfg, tree_map(lambda x: x.cuda(), params),
                            tok.cuda(), None, shape)
        for r in ranks:
            got, launches = r[key]
            assert launches > 0, key
            for a, b in zip(got, want):
                assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
            for a, b in zip(got, ranks[0][key][0]):
                np.testing.assert_array_equal(a, b)
