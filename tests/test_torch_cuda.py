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
def test_cuda_flash_attention_rejects_unaligned_rows():
    need_card()
    x = torch.zeros((1, 16 * 2 * 64 + 1), device="cuda",
                    dtype=torch.bfloat16)
    q = x[:, 1:].view(1, 16, 2, 64)
    kv = torch.zeros((1, 16, 1, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv, causal=True)


def test_port_import_pulls_in_no_jax():
    """Importing the whole port loads neither JAX nor the JAX package."""
    code = ("import sys; import repro_torch.engine, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.graphgen, "
            "repro_torch.models.attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})
