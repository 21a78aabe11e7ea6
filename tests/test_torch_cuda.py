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


def test_port_import_pulls_in_no_jax():
    """Importing the whole port loads neither JAX nor the JAX package."""
    code = ("import sys; import repro_torch.engine, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.graphgen, "
            "repro_torch.models.attention, repro_torch.io, "
            "repro_torch.launch.stream, repro_torch.launch.ingest, "
            "repro_torch.obs, repro_torch.launch.obs, "
            "repro_torch.partition; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})
