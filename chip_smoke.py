#!/usr/bin/env python3
"""Drive the PyTorch port of GSL-LPA on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases main,wide_fit,skew_fit,timing
        # only those phases, and no result line (a phase needs the phases
        # whose graphs it reuses: dense needs wide_fit, microbatch batch,
        # stream main).  The script imports the
        # package beside it, so a copy of it in the root of another
        # checkout (a parent commit unpacked with git archive) measures
        # that checkout with the same phases, for a comparison.

Phases, one JSON line each:

  device   nvidia-smi name and power limit; torch, CUDA and Python versions.
  build    nvcc build of the CUDA kernels (seconds, registers, spills).
  kernels  each kernel against its plain PyTorch version on random inputs:
           widths D in {1, ..., 9, 16, 32, 33, 64, 128, 512, 1024} (every
           narrow instance, the first wide width, an unaligned wide row),
           hash seeds {0, 1, 12345, -1}, edgeless rows and rows whose own
           label is absent.  Integer weights must agree exactly; real
           weights must satisfy the brute-force argmax property at rtol
           1e-5; fused and unfused kernels must agree bit for bit,
           all-inactive and all-klass-false rows included; fused_split
           with prune on and off, chg random and all ones.
  parity   tile backend (kernels) against segment backend on small graphs,
           every split mode, shortcut, fusion on and off.
  c1       a real-weight segment fit on the card (planted_partition, 20,000
           vertices, uniform(0.1, 5.0) weights) equals the CPU fit and
           repeats exactly; segment_sum's run sums equal the CPU's bits.
  main     Engine.fit of grid2d(3500) (12.25M vertices, 49M directed edges):
           tile fused, tile unfused and segment give identical labels and
           no internally-disconnected community; each fit's wall time (call
           to result) beside its stage timings.  Launch counts are reset
           just before these fits and read just after.
  wide_fit the same three fits of erdos_renyi(1<<21, 16.0) (2.1M vertices,
           D=64 tiles): identical labels, no disconnected community.
  dense    core.dense on the ER graph's tiles (B1 / B2 called directly):
           lpa_run_dense and split_lp_dense equal the segment lpa_run /
           split_lp, labels and iterations; gsl_lpa / gve_lpa on karate
           club on the card equal their CPU runs.
  skew_fit two segment fits of rmat(20, 16) (hubs of degree ~10^4, long
           per-(vertex, label) runs): equal labels, their timings.
  batch    Engine.fit_many.  Traffic A: 32 members grid2d(side), side =
           400, 410, ..., 710 (10,129,600 vertices, 40,447,360 directed
           edges; bucket 16,777,216 x D=4), tile fused and unfused, launch
           counts reset just before and read just after each; every member
           equals its solo fused tile fit (labels, both iteration counts,
           communities) with no disconnected community; wall times beside
           the 32 solo fits'; then B1-B4 timed on the packed tiles.
           Traffic B: 15 planted_partition(32, 512, 0.04, 0.0005, seed=s)
           plus an edgeless 100-vertex and a one-vertex member (D=64), auto
           (must pick tile), tile unfused and segment, split lp and lpp with
           shortcut, all equal to each member's solo fit.
  obs      repro_torch.obs (needs main, batch).  grid2d(3500) fitted
           with profile="full", tile fused and unfused (launch counts reset
           just before, read just after): labels and both iteration counts
           equal main's, the propagation curves equal each other, the
           split's changed columns too, 2 x lpa_iterations propagation
           rows; the walls of the profiled and the unprofiled fused fit,
           plans warm, median of 3 in turns, and the overhead share.
           Traffic B's first member on the card (tile fused, unfused,
           segment) and on the CPU (segment): equal propagation curves.
           Traffic A through fit_many, profiled: members 0, 15 and 31 have
           their solo fits' curves.  quality="full" and "basic" fits of
           grid2d(3500): labels equal main's, disconnected fraction 0.0,
           modularity equal to the compute_metrics fit's, the
           engine.quality span of each.  A fit's engine.fit span beside
           its host wall; the Chrome trace (build/obs_trace.json) loads;
           the Prometheus text parses; the engine scope's fits counters
           equal the fits made.
  microbatch  a MicroBatcher(max_batch=8) on the card takes 24 of traffic
           B's members from 4 threads; each result equals its solo fit.
  stream   warm starts and streaming.  (a) The main graph, kept on the
           host, under 3 rounds of road edits (1,000 random existing edges
           deleted and 1,000 diagonals (i, j)-(i+1, j+1) inserted per
           round, seed 0) through StreamSession.update on the tile fused
           backend, warm with the delta's frontier: each round equals the
           solo warm Engine.fit on the card (labels, both iteration counts,
           communities) with no disconnected community, and is printed with
           its splice, upload, propagation, split, compact and wall seconds,
           its B3 / B4 launches (reset just before, read just after) and
           the frontier's share, beside a cold fit of the same graph; in
           round 1 the patched graph equals apply_delta's rebuild (every
           array byte for byte, the fingerprint), and B3 is timed on the
           warm fit's first sub-sweep (the frontier active) and B4 on its
           split's first sweep.  (b) 8 planted_partition(32, 512, 0.04,
           0.0005, seed=s) streams, 3 rounds of evolving_sequence(...,
           delta_edges=256, seed=100 + s) through one
           StreamSession(max_batch=8).update_many, warm and as a cold
           replay: each member equals its solo fit.  (c) warm_start="auto":
           a second fit is warm and equals the fit from the first's labels;
           the cache stays at its bound over warm_cache_size + 1 graphs.
  ingest   grid2d(2000) written as MatrixMarket (7,996,000 edges);
           python -m repro_torch.launch.ingest <file> --stats --detect in a
           subprocess (exit 0, detection on the card); load_graph twice
           (parse, then a store hit that shares the entry's pages), both
           equal to grid2d(2000) with its fingerprint; Engine().fit(path)
           equals Engine().fit(grid2d(2000)), and a second fit(path) under
           warm_start="auto" is warm through the stored fingerprint.
  ooc      out-of-core fits (needs main, ingest).  grid2d(3500) under a
           budget of 3/4 of its in-core edge bytes (13 B per slot):
           Engine.fit(g, memory_budget=B), tile fused and unfused (launch
           counts reset just before, read just after each), 4 to 16
           partitions, labels and both iteration counts equal to main's,
           no disconnected community, the ledger's peak within B, B3 / B4
           (fused) or B1 / B2 (unfused) launched once per partition visit;
           the fused fit again with prefetch off and profile="full": the
           prefetched fit's labels and an in-core profiled fit's
           propagation curve; a real-weight segment fit
           (weighted_planted_partition(40, 500, 0.05, 0.001, seed=3))
           out of core against in core; the ingest phase's file through
           python -m repro_torch.launch.ingest --ooc (subprocess) and
           Engine().fit(path, memory_budget=...) reading windows only, both
           equal to the in-core fit(path).  Each fit's line: partitions,
           budget, peak, loads, prefetch and halo-cache hits, bytes saved,
           exchange bytes, plan / propagation / split / compact seconds,
           the wait on window loads, wall beside the in-core
           wall (main's cold fits; the road fits also beside a warm one).
  timing   the four LPA kernels (CUDA events) beside their plain versions
           and bounds, at the main fit's D=4 tiles, the ER graph's D=64
           tiles and planted_partition(128, 1024, 0.3, 0.001)'s D=512
           tiles, with its planted labels and with labels = vertex ids (a
           fit's first sweep).  Each must equal its plain version exactly
           on the graphs' unit weights; label_argmax and fused_move, on
           real weights from a seed, the bits of the slot-order sum
           (ref.label_argmax_slot_order).  min_label and fused_split run
           as a split's first sweep (labels = row ids, comm = the case's
           labels), fused_split with prune off and on.  No kernel may beat
           its bytes bound.
  trace    torch.profiler over one fused fit: top device ops, idle share.
  flash    ops.flash_attention against its plain version (the chunked
           oracle) on the reference's test shapes, ragged, cross and
           Sq > Skv cases, the TMA ring's edges (B=2 with ragged Skv,
           several partial KV tiles, hd=64, one query), bf16 and float32;
           then the main path of this kernel: one causal call at Yi-9B's
           attention width (B=1, S=4096, 32 query heads, 4 KV heads,
           hd=128, bf16) with launch counts reset just before and read
           just after, checked against the plain version and timed beside
           it and beside scaled_dot_product_attention (yardstick only);
           and two more timed calls at that width, S=4096 non-causal and
           S=16384 causal, beside SDPA.

The build fails the run if ptxas reports a spill in the flash kernel or
in any instance of min_label or fused_split, or serialised wgmma in the
flash kernel.

Then the kernels summary line, the nvidia-smi line, and the result line.
Any failure raises: the exit code is then non-zero and no result prints.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
LPA_KERNELS = ("label_argmax", "min_label", "fused_move", "fused_split")
# Yi-9B's attention (src/repro/configs/yi_9b.py) on one 4096-token prompt.
FLASH_MAIN = {"b": 1, "s": 4096, "h": 32, "k": 4, "hd": 128}
# More timed calls at that width: (S, causal).
FLASH_TIMED = ((4096, False), (16384, True))
FLASH_KERNELS = ("flash_wgmma<64>", "flash_wgmma<128>")
# Graphs of the timing phase beyond the main fit: (name, generator call).
ER_GRAPH = "erdos_renyi(1 << 21, 16.0, seed=0)"
PLANTED_GRAPH = "planted_partition(128, 1024, 0.3, 0.001, seed=0)"
SKEW_GRAPH = "rmat(20, 16, seed=0)"
PHASES = ("kernels", "parity", "c1", "main", "wide_fit", "dense",
          "skew_fit", "batch", "obs", "microbatch", "stream", "ingest",
          "ooc", "timing", "trace", "flash")
# phase -> the phases whose graphs and fits it reuses
NEEDS = {"timing": ("main", "wide_fit"), "trace": ("main",),
         "dense": ("wide_fit",), "microbatch": ("batch",),
         "stream": ("main",), "obs": ("main", "batch"),
         "ooc": ("main", "ingest")}
# The obs phase's traffic-A members held against their solo fits.
OBS_MEMBERS = (0, 15, 31)
# The stream phase's road edits of the main graph, grid2d(ROAD_SIDE).
ROAD_SIDE = 3500
ROAD_ROUNDS = 3
ROAD_DELTA_EDGES = 1000
# The ingest phase's file: grid2d(INGEST_SIDE) as MatrixMarket.
INGEST_SIDE = 2000
GRAPH_FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
# Traffic A of the batch phase: 32 road meshes grid2d(side) in one batch.
TRAFFIC_A_SIDES = tuple(range(400, 711, 10))
ARGMAX_KERNELS = ("label_argmax", "fused_move")
SPLIT_KERNELS = ("min_label", "fused_split")
PLAIN_CUBE_FLOATS = 1 << 28   # the plain argmax's D x D cube per chunk
KERNELS = {
    "label_argmax": ("src/repro_torch/kernels/csrc/label_argmax.cu",
                     "src/repro/kernels/label_argmax.py:81"),
    "min_label": ("src/repro_torch/kernels/csrc/min_label.cu",
                  "src/repro/kernels/min_label.py:28"),
    "fused_move": ("src/repro_torch/kernels/csrc/fused_move.cu",
                   "src/repro/kernels/fused_sweep.py:65"),
    "fused_split": ("src/repro_torch/kernels/csrc/fused_split.cu",
                    "src/repro/kernels/fused_sweep.py:128"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------- kernels

def _random_case(torch, rows, d, seed, integer, dev):
    rng = np.random.default_rng(seed + 7919 * d)
    n_labels = max(d // 2, 2)
    nbr = rng.integers(0, rows, size=(rows, d)).astype(np.int32)
    labels = rng.integers(0, n_labels, size=rows).astype(np.int32)
    absent = labels[1::7]
    labels[1::7] = n_labels + 1 + np.arange(len(absent))  # own label absent
    mask = rng.random((rows, d)) < 0.8
    mask[0] = False                      # edgeless rows
    mask[3] = False
    nbr[3] = 3                           # ... one self-pointing, as padded
    if integer:
        w = rng.integers(1, 5, size=(rows, d)).astype(np.float32)
    else:
        w = rng.uniform(0.1, 5.0, size=(rows, d)).astype(np.float32)
    comm = rng.integers(0, 4, size=rows).astype(np.int32)
    chg = rng.random(rows) < 0.3
    state = [rng.random(rows) < p for p in (0.6, 0.4, 0.7)]
    real = np.ones(rows, bool)
    real[-max(rows // 8, 1):] = False
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        nbr=nbr, nw=w, nmask=mask, labels=labels, comm=comm, chg=chg,
        active=state[0], cand_prev=state[1], klass=state[2],
        real=real).items()}
    return t


def _argmax_property(torch, t, out, seed, rtol=1e-5):
    """Brute force in float64: best weight and chosen label reach the true
    per-label maximum; current weight is the own label's sum."""
    best_lab, best_w, cur_w = (x.cpu().numpy() for x in out)
    nbr, w = t["nbr"].cpu().numpy(), t["nw"].cpu().numpy()
    mask, labels = t["nmask"].cpu().numpy(), t["labels"].cpu().numpy()
    lab = labels[nbr]
    for i in range(nbr.shape[0]):
        acc: dict = {}
        for j in np.flatnonzero(mask[i]):
            acc[lab[i, j]] = acc.get(lab[i, j], 0.0) + float(w[i, j])
        if not acc:
            check(best_w[i] == 0.0 and best_lab[i] == 2147483647,
                  f"edgeless row {i}: {best_lab[i]} {best_w[i]}")
            continue
        best = max(acc.values())
        check(abs(best_w[i] - best) <= rtol * best, f"row {i} best_w")
        check(best_lab[i] in acc
              and abs(acc[best_lab[i]] - best) <= rtol * best,
              f"row {i} best_lab")
        own = acc.get(labels[i], 0.0)
        check(abs(cur_w[i] - own) <= rtol * max(own, 1e-30),
              f"row {i} cur_w")


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch, ops, ref, dev):
    widths = (*range(1, 10), 16, 32, 33, 64, 128, 512, 1024)
    seeds = (0, 1, 12345, -1)
    rows_for = {**{d: 4096 for d in range(1, 10)}, 16: 4096, 32: 2048,
                33: 2048, 64: 1024, 128: 512, 512: 128, 1024: 40}
    err = {k: 0.0 for k in LPA_KERNELS}
    cases = 0
    for d in widths:
        rows = rows_for[d]
        ti = _random_case(torch, rows, d, 11, True, dev)
        tr = _random_case(torch, rows, d, 12, False, dev)
        # fused_move's early exits: no row active (act only from the
        # wake), no row in the sub-sweep's class (no argmax at all)
        none = torch.zeros_like(tr["active"])
        states = (ti, tr, {**tr, "active": none}, {**tr, "klass": none})
        for seed in seeds:
            # label_argmax: exact on integer weights, property on real ones
            k = ops.label_argmax(ti["nbr"], ti["nw"], ti["nmask"],
                                 ti["labels"], seed)
            p = ref.label_argmax_ref(ti["nbr"], ti["nw"], ti["nmask"],
                                     ti["labels"], seed)
            err["label_argmax"] = max(err["label_argmax"],
                                      *(_err(a, b) for a, b in zip(k, p)))
            kr = ops.label_argmax(tr["nbr"], tr["nw"], tr["nmask"],
                                  tr["labels"], seed)
            _argmax_property(torch, tr, kr, seed)

            # fused_move: exact vs plain, bit-identical to the unfused kernel
            args = (ti["nbr"], ti["nw"], ti["nmask"], ti["labels"],
                    ti["chg"], ti["active"], ti["cand_prev"], ti["klass"],
                    ti["real"], seed)
            kf = ops.fused_move(*args)
            pf = ref.fused_move_ref(*args)
            err["fused_move"] = max(err["fused_move"],
                                    *(_err(a, b) for a, b in zip(kf, pf)))
            for t in states:
                new, act = ops.fused_move(
                    t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                    t["active"], t["cand_prev"], t["klass"], t["real"], seed)
                bl, bw, cw = ops.label_argmax(t["nbr"], t["nw"], t["nmask"],
                                              t["labels"], seed)
                wake = (t["chg"][t["nbr"]] & t["nmask"]).any(dim=1)
                act_sep = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
                adopt = act_sep & t["klass"] & (bw > cw.clamp_min(0.0))
                new_sep = torch.where(adopt, bl, t["labels"])
                check(torch.equal(new, new_sep) and torch.equal(act, act_sep),
                      f"fused_move != label_argmax + glue (d={d} s={seed})")
            cases += 1
        # min_label / fused_split are seed-free integer ops
        for t in (ti, tr):
            margs = (t["nbr"], t["nmask"], t["labels"], t["comm"])
            km = ops.min_label(*margs)
            err["min_label"] = max(err["min_label"],
                                   _err(km, ref.min_label_ref(*margs)))
            for prune in (True, False):
                for chg in (t["chg"], torch.ones_like(t["chg"])):
                    ks = ops.fused_split(*margs, chg, prune)
                    ps = ref.fused_split_ref(*margs, chg, prune)
                    err["fused_split"] = max(err["fused_split"],
                                             _err(ks, ps))
                    if not prune or bool(chg.all()):
                        check(torch.equal(ks, km),
                              f"fused_split != min_label (d={d})")
    torch.cuda.synchronize()
    for name, e in err.items():
        check(e == 0.0, f"{name} disagrees with its plain version: {e}")
    return {"widths": list(widths), "seeds": list(seeds), "cases": cases,
            "rtol_real_weights": 1e-5, "max_abs_err": err}


# ---------------------------------------------------------------- parity

def phase_parity(torch, rt, dev):
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import (
        erdos_renyi,
        figure1_graph,
        karate_club,
        planted_partition,
    )
    graphs = {"karate": karate_club()[0], "er": erdos_renyi(180, 5.0, seed=11),
              "planted": planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              "figure1": figure1_graph()[0]}
    rt.ops.reset_launches()
    out = []
    for split, shortcut in (("none", False), ("lp", False), ("lpp", False),
                            ("lp", True), ("lpp", True)):
        for gname, g in graphs.items():
            seg = Engine(EngineConfig(split=split, shortcut=shortcut,
                                      backend="segment"),
                         cache=PlanCache()).fit(g)
            for fuse in ("on", "off"):
                eng = Engine(EngineConfig(split=split, shortcut=shortcut,
                                          fuse_sweeps=fuse),
                             cache=PlanCache())
                res = eng.fit(g)
                check(res.backend == "tile", "auto did not pick tile on CUDA")
                same = (np.array_equal(res.labels, seg.labels)
                        and res.lpa_iterations == seg.lpa_iterations
                        and res.split_iterations == seg.split_iterations
                        and res.num_communities == seg.num_communities)
                check(same, f"tile != segment: {gname} {split} "
                            f"shortcut={shortcut} fuse={fuse}")
                if split != "none":
                    check(res.check_connected(g) == 0.0,
                          f"disconnected community: {gname} {split}")
            out.append({"graph": gname, "split": split, "shortcut": shortcut,
                        "lpa_iterations": seg.lpa_iterations,
                        "split_iterations": seg.split_iterations,
                        "communities": seg.num_communities})
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched in the parity fits")
    return {"cases": out, "launches": launches}


# -------------------------------------------------------------------- c1

def phase_c1(torch, dev):
    """Real weights on the segment path: the card's fit equals the CPU
    port's (held to the JAX package on the CPU by the tests) and repeats;
    segment_sum folds each run in index order on both devices."""
    from repro_torch.core.lpa import segment_sum
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import weighted_planted_partition
    g = weighted_planted_partition(40, 500, 0.05, 0.001, seed=3)
    cfg = dict(split="lp", backend="segment")
    want = Engine(EngineConfig(device="cpu", **cfg), cache=PlanCache()).fit(g)
    fits = [Engine(EngineConfig(**cfg), cache=PlanCache()).fit(g)
            for _ in range(2)]
    for i, res in enumerate(fits):
        check(res.device.startswith("cuda"), "c1: the fit did not run on "
              "the card")
        check(np.array_equal(res.labels, want.labels)
              and res.lpa_iterations == want.lpa_iterations
              and res.split_iterations == want.split_iterations,
              f"c1: CUDA segment fit {i} != CPU fit on real weights")
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 500, size=1 << 20))
    val = rng.uniform(0.1, 5.0, size=seg.size).astype(np.float32)
    sums = [segment_sum(torch.from_numpy(val).to(d),
                        torch.from_numpy(seg).to(d), 500).cpu().view(
                            torch.int32) for d in ("cpu", dev, dev)]
    check(all(torch.equal(sums[0], x) for x in sums[1:]),
          "c1: segment_sum on the card != the CPU's bits")
    return {"graph": "planted_partition(40, 500, 0.05, 0.001, seed=3), "
                     "uniform(0.1, 5.0) weights", "n": g.n,
            "directed_edges": g.num_edges, "split": "lp",
            "lpa_iterations": want.lpa_iterations,
            "split_iterations": want.split_iterations,
            "communities": want.num_communities,
            "cuda_total_s": [r.total_seconds for r in fits],
            "cpu_total_s": want.total_seconds,
            "segment_sum_runs": 500, "segment_sum_values": int(seg.size)}


# ------------------------------------------------------------------ main

def _wall(torch, fn):
    """(result, seconds from the call to its result, the device idle)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _three_fits(torch, rt, g):
    """Tile fused, tile unfused and segment fits (split lp) of ``g``, with
    the launch counts (reset just before the tile fits, read just after),
    the peak device memory of the tile fits and each fit's wall time, from
    the call to the result, beside the sum of its stage timings."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    walls = {}

    def fit(**kw):
        res, wall = _wall(torch, lambda: Engine(
            EngineConfig(split="lp", **kw), cache=PlanCache()).fit(g))
        walls[id(res)] = wall
        return res

    torch.cuda.reset_peak_memory_stats()
    rt.ops.reset_launches()
    fused = fit(backend="tile")
    launches_fused = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    unfused = fit(backend="tile", fuse_sweeps="off")
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    segment = fit(backend="segment")
    for name, res in (("unfused tile", unfused), ("segment", segment)):
        check(np.array_equal(res.labels, fused.labels)
              and res.lpa_iterations == fused.lpa_iterations
              and res.split_iterations == fused.split_iterations,
              f"{name} labels differ from the fused tile fit")
    frac = fused.check_connected(g)
    check(frac == 0.0, f"disconnected fraction {frac}")

    def summary(res):
        wall = walls[id(res)]
        return {"timings_s": res.timings, "total_s": res.total_seconds,
                "compact_s": res.timings["compact"], "wall_s": wall,
                "outside_stages_s": wall - res.total_seconds,
                "edges_per_s": g.num_edges / res.total_seconds,
                "edges_per_wall_s": g.num_edges / wall}

    return fused, {
        "n": g.n, "directed_edges": g.num_edges,
        "bucket": list(fused.bucket),
        "lpa_iterations": fused.lpa_iterations,
        "split_iterations": fused.split_iterations,
        "communities": fused.num_communities,
        "disconnected_fraction": frac,
        "fused": summary(fused), "unfused": summary(unfused),
        "segment": summary(segment),
        "launches": launches, "launches_fused_fit": launches_fused,
        "launches_unfused_fit": {k: launches[k] - launches_fused[k]
                                 for k in launches},
        "peak_bytes_tile_fits": peak}


def phase_main(torch, rt, dev):
    from repro_torch.graphgen import grid2d
    t0 = time.perf_counter()
    g = grid2d(3500).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fused, res = _three_fits(torch, rt, g)
    for name, n in res["launches"].items():
        check(n > 0, f"{name} was not launched by the main fits")
    return g, fused, {"graph": "grid2d(3500)", "graph_build_s": build_s,
                      **res}


def phase_wide_fit(torch, rt, dev):
    """The main fit's check at D=64 tiles: tile fused, tile unfused and
    segment fits of the ER graph give identical labels and iteration
    counts and no internally-disconnected community."""
    from repro_torch.graphgen import erdos_renyi
    t0 = time.perf_counter()
    g = erdos_renyi(1 << 21, 16.0, seed=0).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fused, res = _three_fits(torch, rt, g)
    return g, fused, {"graph": ER_GRAPH, "graph_build_s": build_s, **res}


def phase_skew_fit(torch, dev):
    """Two segment fits (split lp) of a skewed graph: R-MAT with Graph500's
    parameters, whose hubs give long (vertex, label) runs, each summed by
    one thread in segment_sum.  The fits must agree; the labels' digest
    lets runs of other checkouts be compared with them."""
    import hashlib

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import rmat
    t0 = time.perf_counter()
    g = rmat(20, 16, seed=0).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fits = [Engine(EngineConfig(backend="segment", split="lp"),
                   cache=PlanCache()).fit(g) for _ in range(2)]
    a, b = fits
    check(np.array_equal(a.labels, b.labels)
          and (a.lpa_iterations, a.split_iterations)
          == (b.lpa_iterations, b.split_iterations),
          "skew_fit: two segment fits of one graph differ")
    frac = a.check_connected(g)
    check(frac == 0.0, f"skew_fit: disconnected fraction {frac}")
    # the longest (vertex, community) run of the result: what one thread
    # folds in the last sweeps
    src = g.src[:g.num_edges].long()
    lab = torch.from_numpy(np.asarray(a.labels)).to(dev).long()
    key = src * g.n + lab[g.dst[:g.num_edges].long()]
    return {"graph": SKEW_GRAPH, "graph_build_s": build_s, "n": g.n,
            "directed_edges": g.num_edges,
            "max_degree": int(torch.bincount(src).max()),
            "longest_run": int(torch.unique(key, return_counts=True)[1]
                               .max()),
            "lpa_iterations": a.lpa_iterations,
            "split_iterations": a.split_iterations,
            "communities": a.num_communities, "disconnected_fraction": frac,
            "labels_sha256": hashlib.sha256(
                np.asarray(a.labels).tobytes()).hexdigest()[:16],
            "fits": [{"timings_s": r.timings, "total_s": r.total_seconds,
                      "edges_per_s": g.num_edges / r.total_seconds}
                     for r in fits]}


# ----------------------------------------------------------------- dense

def phase_dense(torch, rt, g, dev):
    """``core.dense`` on the card (B1 and B2 called directly on the ER
    graph's tiles) against the segment path on the same graph; then the
    ``gsl_lpa`` / ``gve_lpa`` facades on the card against the CPU."""
    from repro_torch.core import dense, gsl_lpa, gve_lpa
    from repro_torch.core.lpa import lpa_run
    from repro_torch.core.split import split_lp
    from repro_torch.graphgen import karate_club
    pg = dense.pad_graph(g)
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    (labels, iters), lpa_s = _wall(torch, lambda: dense.lpa_run_dense(pg))
    (split, split_iters), split_s = _wall(
        torch, lambda: dense.split_lp_dense(pg, labels))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    check(launches["label_argmax"] == 2 * iters
          and launches["min_label"] == split_iters,
          f"dense: launches {launches} for {iters} / {split_iters} sweeps")
    seg, seg_lpa_s = _wall(torch, lambda: lpa_run(g))
    seg_split, seg_split_s = _wall(torch, lambda: split_lp(g, seg.labels))
    check(torch.equal(labels, seg.labels) and iters == seg.iteration,
          "dense: lpa_run_dense != the segment lpa_run")
    check(torch.equal(split, seg_split.labels)
          and split_iters == seg_split.iterations,
          "dense: split_lp_dense != the segment split_lp")
    karate = karate_club()[0]
    facades = {}
    for fn in (gsl_lpa, gve_lpa):
        card, cpu = fn(karate), fn(karate, device="cpu")
        check(card.detail.device.startswith("cuda")
              and np.array_equal(card.labels, cpu.labels)
              and (card.lpa_iterations, card.split_iterations)
              == (cpu.lpa_iterations, cpu.split_iterations),
              f"dense: {fn.__name__} on the card != on the CPU")
        facades[fn.__name__] = {"communities": int(card.labels.max()) + 1,
                                "lpa_iterations": card.lpa_iterations,
                                "split_iterations": card.split_iterations}
    return {"graph": ER_GRAPH, "rows": pg.n_pad, "d": pg.d_max,
            "lpa_iterations": iters, "split_iterations": split_iters,
            "launches": launches, "dense_lpa_s": lpa_s,
            "dense_split_s": split_s, "segment_lpa_s": seg_lpa_s,
            "segment_split_s": seg_split_s,
            "karate_club_facades": facades}


# ----------------------------------------------------------------- batch

def _traffic_a():
    from repro_torch.graphgen import grid2d
    return [grid2d(side) for side in TRAFFIC_A_SIDES]


def _traffic_b():
    from repro_torch.core.graph import build_graph
    from repro_torch.graphgen import planted_partition
    edgeless = np.zeros((0, 2), np.int64)
    return ([planted_partition(32, 512, 0.04, 0.0005, seed=s)[0]
             for s in range(15)]
            + [build_graph(edgeless, n=100), build_graph(edgeless, n=1)])


def _same_fit(a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and (a.lpa_iterations, a.split_iterations, a.num_communities)
            == (b.lpa_iterations, b.split_iterations, b.num_communities))


def _no_disconnected(torch, graphs, results, dev) -> float:
    """Disconnected-community fraction over all members at once: the
    members' labels, shifted apart, on their packed disjoint union (a
    community of the union is disconnected iff it is in its member)."""
    from repro_torch.core.batch import GraphBatch
    from repro_torch.core.detect import disconnected_fraction
    batch = GraphBatch.pack(graphs, device=dev)
    shift = np.cumsum([0] + [r.num_communities for r in results[:-1]])
    comm = np.concatenate([r.labels + s for r, s in zip(results, shift)])
    return float(disconnected_fraction(batch.graph,
                                       torch.from_numpy(comm).to(dev)))


def _fit_many_timed(torch, rt, graphs, **cfg):
    """One fit_many with its wall time and the LPA kernels' launches
    (reset just before, read just after)."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    res, wall = _wall(torch, lambda: eng.fit_many(graphs))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    stages = {k: sum(r.timings[k] for r in res) for k in res[0].timings}
    return res, {"wall_s": wall, "stage_s": stages,
                 "bucket": list(res[0].bucket), "backend": res[0].backend,
                 "launches": launches}


def _solo_fits(torch, graphs, **cfg):
    """Each member's solo fit, with the sum of their wall times."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    out, total = [], 0.0
    for g in graphs:
        res, wall = _wall(torch, lambda g=g: eng.fit(g))
        out.append(res)
        total += wall
    return out, total


def phase_batch(torch, rt, dev):
    """Engine.fit_many on traffic A (32 road meshes, tile fused and
    unfused) and B (17 mixed members, auto = tile fused, tile unfused and
    segment, split lp and lpp + shortcut); every member equals its solo
    fused tile fit and has no disconnected community.  Members start on
    the host, as users send them, for the batched and the solo fits
    alike.  Then the four LPA kernels on traffic A's packed tiles."""
    from repro_torch.core.batch import GraphBatch
    from repro_torch.engine import EngineConfig
    from repro_torch.engine.bucketing import batch_bucket_for
    from repro_torch.engine.registry import choose_backend_batch
    out = {}

    # traffic A: batches of road-mesh graphs from many users
    t0 = time.perf_counter()
    graphs = _traffic_a()
    build_s = time.perf_counter() - t0
    graphs_a = graphs
    solo, solo_s = _solo_fits(torch, graphs, backend="tile", split="lp")
    runs = {}
    for tag, fuse in (("fused", "on"), ("unfused", "off")):
        res, row = _fit_many_timed(torch, rt, graphs, backend="tile",
                                   split="lp", fuse_sweeps=fuse)
        for i, (r, s) in enumerate(zip(res, solo)):
            check(_same_fit(r, s) and r.batch_index == i
                  and r.batch_size == len(graphs),
                  f"batch A {tag}: member {i} != its solo fused tile fit")
        runs[tag] = row
    batch_launches = {k: runs["fused"]["launches"][k]
                      + runs["unfused"]["launches"][k] for k in LPA_KERNELS}
    for k, v in batch_launches.items():
        check(v > 0, f"batch A: {k} was not launched by the fit_many runs")
    frac = _no_disconnected(torch, graphs, res, dev)
    check(frac == 0.0, f"batch A: disconnected fraction {frac}")
    check(choose_backend_batch(graphs, EngineConfig(), dev) == "segment",
          "batch A: auto should pick segment at this size")
    # the four kernels on the packed shape, with the fit's labels
    batch = GraphBatch.pack(graphs, device=dev)
    bucket = batch_bucket_for(batch)
    shift = np.repeat(batch.offsets[:-1], batch.sizes).astype(np.int32)
    labels = np.concatenate([s.labels for s in solo]) + shift
    t = _timing_tiles(torch, batch.graph, bucket.n, bucket.d, labels, dev)
    kern = _time_argmax(torch, rt, t, plain_reps=5)
    kern.update(_time_split(torch, rt, t, plain_reps=5))
    del t, batch
    out["traffic_a"] = {
        "members": f"grid2d(side), side = {TRAFFIC_A_SIDES[0]}, "
                   f"{TRAFFIC_A_SIDES[1]}, ..., {TRAFFIC_A_SIDES[-1]}",
        "k": len(graphs), "vertices": sum(g.n for g in graphs),
        "directed_edges": sum(g.num_edges for g in graphs),
        "graph_build_s": build_s, "split": "lp",
        "lpa_iterations_min_max": [min(r.lpa_iterations for r in solo),
                                   max(r.lpa_iterations for r in solo)],
        "split_iterations_min_max": [min(r.split_iterations for r in solo),
                                     max(r.split_iterations for r in solo)],
        "disconnected_fraction": frac, **runs,
        "solo_fused_tile_wall_sum_s": solo_s,
        "batch_launches": batch_launches, "kernels_packed_shape": kern}

    # traffic B: many medium graphs of mixed shape in one dispatch
    t0 = time.perf_counter()
    graphs = _traffic_b()
    build_s = time.perf_counter() - t0
    check(choose_backend_batch(graphs, EngineConfig(), dev) == "tile",
          "batch B: auto did not pick tile on CUDA")
    cases = []
    for split, shortcut in (("lp", False), ("lpp", True)):
        cfg = dict(split=split, shortcut=shortcut)
        solo_b, solo_b_s = _solo_fits(torch, graphs, **cfg)
        if split == "lp":
            solo_lp = solo_b
        row = {"split": split, "shortcut": shortcut,
               "solo_auto_wall_sum_s": solo_b_s}
        for tag, kw in (("auto", {}), ("tile_unfused",
                                       dict(backend="tile", fuse_sweeps="off")),
                        ("segment", dict(backend="segment"))):
            res, run = _fit_many_timed(torch, rt, graphs, **cfg, **kw)
            for i, (r, s) in enumerate(zip(res, solo_b)):
                check(_same_fit(r, s), f"batch B {split} {tag}: member {i} "
                      f"!= its solo fit")
            row[tag] = run
        check(row["auto"]["backend"] == "tile"
              and row["auto"]["bucket"][3] == 64,
              f"batch B: auto ran {row['auto']['backend']} at "
              f"{row['auto']['bucket']}")
        frac = _no_disconnected(torch, graphs, res, dev)
        check(frac == 0.0, f"batch B {split}: disconnected fraction {frac}")
        row["disconnected_fraction"] = frac
        cases.append(row)
    out["traffic_b"] = {
        "members": "planted_partition(32, 512, 0.04, 0.0005, seed=s), "
                   "s = 0..14; edgeless 100-vertex; one vertex",
        "k": len(graphs), "vertices": sum(g.n for g in graphs),
        "directed_edges": sum(g.num_edges for g in graphs),
        "max_degree": max(int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
                          for g in graphs if g.num_edges),
        "graph_build_s": build_s, "cases": cases}
    return graphs_a, graphs, solo_lp, batch_launches, out


def phase_microbatch(torch, graphs, solo):
    """A MicroBatcher(max_batch=8) over the card takes 24 submissions,
    drawn from traffic B's members, from 4 threads; every result equals
    the member's solo fit.  Every wait is bounded."""
    import threading

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.launch.microbatch import MicroBatcher
    picks = [(7 * i) % len(graphs) for i in range(24)]
    subs = [None] * len(picks)
    mb = MicroBatcher(Engine(EngineConfig(split="lp"), cache=PlanCache()),
                      max_batch=8, batch_timeout_ms=20.0)

    def client(c):
        for j in range(c, len(picks), 4):
            subs[j] = mb.submit(graphs[picks[j]])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        check(not th.is_alive(), "microbatch: a client thread hung")
    results = [s.result(timeout=300) for s in subs]
    wall = time.perf_counter() - t0
    mb.close(timeout=120)
    check(not mb._thread.is_alive(), "microbatch: the worker did not stop")
    for j, (i, r) in enumerate(zip(picks, results)):
        check(_same_fit(r, solo[i]) and r.device.startswith("cuda"),
              f"microbatch: submission {j} (member {i}) != its solo fit")
    check(sum(mb.batch_sizes) == len(picks)
          and max(mb.batch_sizes) <= 8, f"microbatch: batches "
          f"{mb.batch_sizes}")
    return {"submissions": len(picks), "threads": 4, "max_batch": 8,
            "batch_sizes": mb.batch_sizes, "wall_s": wall, **mb.stats()}


# ------------------------------------------------------------------- obs

def _same_phase(a, b, cols=("sweep", "active", "changed")) -> bool:
    return (a is None) == (b is None) and (a is None or all(
        np.array_equal(getattr(a, c), getattr(b, c)) for c in cols))


def _same_profile(a, b) -> bool:
    return a.n == b.n and _same_phase(a.propagation, b.propagation) \
        and _same_phase(a.split, b.split)


def phase_obs(torch, rt, dev, g, fused, graphs_a, graphs_b):
    """repro_torch.obs on the card: convergence profiles carried through
    the four LPA kernels (profiled fits equal main's unprofiled fits; the
    curves agree across fusion, backends, the CPU and fit_many), quality
    reports, spans against the host wall, the Chrome trace and the
    Prometheus text.  Launch counts are reset just before the two
    profiled main-graph fits and read just after."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.obs import (REGISTRY, TRACER, parse_prometheus_text,
                                 prometheus_text)
    out = {}

    def engine(**kw):
        return Engine(EngineConfig(split="lp", **kw), cache=PlanCache())

    # the main graph, profile="full", fused and unfused
    prof_f = engine(backend="tile", profile="full")
    prof_u = engine(backend="tile", fuse_sweeps="off", profile="full")
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    rf, wall_f = _wall(torch, lambda: prof_f.fit(g))
    launches_f = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    ru, wall_u = _wall(torch, lambda: prof_u.fit(g))
    launches = {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"obs: {name} was not launched by the profiled fits")
    for tag, r in (("fused", rf), ("unfused", ru)):
        check(_same_fit(r, fused), f"obs: the profiled {tag} fit differs "
              f"from main's unprofiled fits")
        check(r.profile.propagation.num_sub_sweeps
              == 2 * r.lpa_iterations, f"obs: {tag} propagation rows "
              f"{r.profile.propagation.num_sub_sweeps} != 2 x "
              f"{r.lpa_iterations}")
        check(r.profile.split is not None and not r.profile.split.truncated
              and r.profile.split.num_sub_sweeps == r.split_iterations,
              f"obs: {tag} split curve")
    check(_same_phase(rf.profile.propagation, ru.profile.propagation),
          "obs: fused and unfused propagation curves differ")
    check(_same_phase(rf.profile.split, ru.profile.split,
                      ("sweep", "changed")),
          "obs: fused and unfused split changed columns differ")
    # walls, plans warm: profiled and unprofiled fused fits, in turns
    plain = engine(backend="tile")
    plain.fit(g)
    walls = {"profiled": [], "unprofiled": []}
    prop = {"profiled": [], "unprofiled": []}
    for _ in range(3):
        for tag, eng in (("profiled", prof_f), ("unprofiled", plain)):
            r, wall = _wall(torch, lambda eng=eng: eng.fit(g))
            walls[tag].append(wall)
            prop[tag].append(r.timings["propagation"] + r.timings["split"])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    med_dev = {k: float(np.median(v)) for k, v in prop.items()}
    snap = REGISTRY.snapshot()
    fits = {tag: snap[f"{eng._obs.label}.fits"]
            for tag, eng in (("profiled", prof_f), ("unprofiled", plain))}
    check(fits == {"profiled": 4, "unprofiled": 4},
          f"obs: engine fits counters {fits}, want 4 each")
    # a profile row's count against Tensor.sum() (the unprofiled loop's
    # changed count), on a mask of the bucket's rows
    from repro_torch.obs.convergence import count_true
    mask = torch.rand(fused.bucket[0], device=dev) < 0.5
    want = int(mask.sum())
    check(int(count_true(mask)) == want, "obs: count_true")
    count_ms = {"rows": mask.numel(),
                "sum_ms": _time_ms(torch, mask.sum),
                "count_true_ms": _time_ms(torch, lambda: count_true(mask))}
    del mask
    out["main"] = {
        "graph": "grid2d(3500)", "profile": "full", "split": "lp",
        "first_fit_wall_s": {"fused": wall_f, "unfused": wall_u},
        "launches_fused_fit": launches_f,
        "launches_unfused_fit": {k: launches[k] - launches_f[k]
                                 for k in launches},
        "propagation": rf.profile.propagation.to_dict(),
        "split_fused": rf.profile.split.to_dict(),
        "split_unfused_active": ru.profile.split.active.tolist(),
        "wall_s_median_of_3": med, "walls_s": walls,
        "propagation_plus_split_s_median_of_3": med_dev,
        "profile_overhead_share": med["profiled"] / med["unprofiled"] - 1,
        "profile_overhead_share_of_device_stages":
            med_dev["profiled"] / med_dev["unprofiled"] - 1,
        "engine_fits_counters": fits, "bool_count": count_ms}

    # one traffic-B member: three backends on the card, segment on the CPU
    pp = graphs_b[0]
    fits_b = {}
    for tag, kw in (("tile_fused", dict(backend="tile")),
                    ("tile_unfused", dict(backend="tile",
                                          fuse_sweeps="off")),
                    ("segment", dict(backend="segment")),
                    ("segment_cpu", dict(backend="segment", device="cpu"))):
        fits_b[tag] = engine(profile="full", **kw).fit(pp)
    for tag, r in fits_b.items():
        check(_same_fit(r, fits_b["segment_cpu"])
              and _same_phase(r.profile.propagation,
                              fits_b["segment_cpu"].profile.propagation),
              f"obs: {tag} propagation curve != the CPU segment fit's")
    out["backends"] = {
        "graph": "planted_partition(32, 512, 0.04, 0.0005, seed=0)",
        "devices": {k: r.device for k, r in fits_b.items()},
        "propagation_active": fits_b["segment_cpu"].profile.propagation
        .active.tolist(),
        "split_changed": {k: r.profile.split.changed.tolist()
                          for k, r in fits_b.items()}}

    # traffic A: fit_many profiled, members against their solo fits
    eng_a = engine(backend="tile", profile="full")
    res_a, wall_a = _wall(torch, lambda: eng_a.fit_many(graphs_a))
    for i in OBS_MEMBERS:
        solo = eng_a.fit(graphs_a[i])
        check(_same_fit(res_a[i], solo)
              and _same_profile(res_a[i].profile, solo.profile),
              f"obs: traffic A member {i}'s curves != its solo fit's")
    out["traffic_a"] = {"fit_many_wall_s": wall_a,
                        "members_checked": list(OBS_MEMBERS),
                        "lpa_iterations": [res_a[i].lpa_iterations
                                           for i in OBS_MEMBERS]}

    # quality reports on the main graph
    metric = engine(backend="tile", compute_metrics=True).fit(g)
    quality = {}
    for mode in ("full", "basic"):
        eng = engine(backend="tile", quality=mode)
        TRACER.reset()
        r, wall = _wall(torch, lambda eng=eng: eng.fit(g))
        check(_same_fit(r, fused), f"obs: quality={mode} labels differ")
        q = r.quality
        (qs,) = TRACER.spans("engine.quality")
        quality[mode] = {"engine_quality_s": qs.dur, "wall_s": wall,
                         "report": q.to_dict()}
        if mode == "full":
            check(q.disconnected_fraction == 0.0,
                  f"obs: disconnected fraction {q.disconnected_fraction}")
            check(q.modularity == metric.modularity,
                  f"obs: quality modularity {q.modularity} != "
                  f"compute_metrics' {metric.modularity}")
        else:
            check(q.modularity is None and q.disconnected_fraction is None,
                  "obs: basic quality made a device pass")
    quality["compute_metrics_modularity"] = metric.modularity
    out["quality"] = quality

    # spans against the host wall, the Chrome trace, the Prometheus text
    eng = engine(backend="tile")
    eng.fit(g)
    TRACER.reset()
    r, wall = _wall(torch, lambda: eng.fit(g))
    names = {s.name for s in TRACER.spans("engine.")}
    need = {"engine.fit", "engine.prepare", "engine.dispatch",
            "engine.compact"}
    check(need <= names, f"obs: spans {sorted(names)}")
    spans = {s.name: s.dur for s in TRACER.spans("engine.")}
    trace_path = Path(__file__).resolve().parent / "build" / "obs_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    n_events = TRACER.export_chrome(trace_path)
    events = json.loads(trace_path.read_text())
    check(len(events) == n_events >= 4, "obs: the Chrome trace")
    parsed = parse_prometheus_text(prometheus_text())
    label = eng._obs.label
    snap = REGISTRY.snapshot()
    check(snap[f"{label}.fits"] == 2, f"obs: {label}.fits = "
          f"{snap[f'{label}.fits']}, want 2")
    out["spans"] = {
        "engine_fit_span_s": spans["engine.fit"], "host_wall_s": wall,
        "span_over_wall": spans["engine.fit"] / wall,
        "stage_spans_s": spans, "timings_s": r.timings,
        "chrome_trace": str(trace_path.relative_to(
            Path(__file__).resolve().parent)), "trace_events": n_events,
        "prometheus_metrics": len(parsed),
        "engine_names": sorted({k.split(".", 1)[1] for k in snap
                                if k.startswith("engine")})}
    return launches, out


# ---------------------------------------------------------------- stream

def _road_delta(rng, graph, used_cells, side, k):
    """One road edit: ``k`` random existing undirected edges deleted and
    ``k`` diagonals (i, j)-(i+1, j+1) inserted, a shape the 4-neighbour
    lattice never has; a diagonal is inserted once per run."""
    from repro_torch.core.delta import GraphDelta
    m = graph.num_edges
    src, dst = graph.src.numpy()[:m], graph.dst.numpy()[:m]
    idx = rng.integers(0, m, size=4 * k)
    idx = idx[src[idx] < dst[idx]]
    dels = np.unique(np.stack([src[idx], dst[idx]], axis=1), axis=0)
    dels = dels[rng.permutation(len(dels))[:k]]
    cells = np.setdiff1d(rng.integers(0, (side - 1) ** 2, size=3 * k),
                         used_cells)
    cells = cells[rng.permutation(len(cells))[:k]]
    check(len(dels) == k and len(cells) == k, "stream: short road delta")
    i, j = cells // (side - 1), cells % (side - 1)
    ins = np.stack([i * side + j, (i + 1) * side + j + 1], axis=1)
    return GraphDelta.make(insert=ins, delete=dels), \
        np.union1d(used_cells, cells)


def _fit_line(res, wall, launches, **extra):
    """The printed line of one road fit (a session update's member or a
    solo fit)."""
    return {"propagation_s": res.lpa_seconds, "split_s": res.split_seconds,
            "compact_s": res.timings["compact"], "timings_s": res.timings,
            "wall_s": wall, "lpa_iterations": res.lpa_iterations,
            "split_iterations": res.split_iterations,
            "communities": res.num_communities,
            "launches": {k: launches[k] for k in ("fused_move",
                                                  "fused_split")},
            **extra}


def _launched(torch, rt, fn):
    """``fn()`` with its wall time and the LPA kernels' launches (reset
    just before, read just after)."""
    torch.cuda.synchronize()
    rt.ops.reset_launches()
    out, wall = _wall(torch, fn)
    return out, wall, {k: rt.ops.LAUNCHES[k] for k in LPA_KERNELS}


def _same_graph(a, b) -> bool:
    from repro_torch.core.graph import graph_fingerprint
    return ((a.n, a.m_pad, a.num_edges) == (b.n, b.m_pad, b.num_edges)
            and all(_tensors_equal(getattr(a, f), getattr(b, f))
                    for f in GRAPH_FIELDS)
            and graph_fingerprint(a) == graph_fingerprint(b))


def _tensors_equal(x, y) -> bool:
    return x.dtype == y.dtype and x.shape == y.shape \
        and bool((x.cpu() == y.cpu()).all())


def _frontier_sweep(torch, rt, post, rows, d, prev, front, dev):
    """B3 on the first sub-sweep of a warm fit of ``post`` (labels ``prev``,
    the frontier active, nothing changed yet, the first sweep's class) and
    B4 on its split's first sweep: exact against the plain versions,
    timed, with their bounds."""
    from repro_torch.kernels.ref import label_hash
    t = _timing_tiles(torch, post, rows, d, prev, dev)
    active = torch.zeros(rows, dtype=torch.bool, device=dev)
    active[: post.n] = torch.from_numpy(front).to(dev)
    t.update(active=active, chg=torch.zeros_like(active),
             klass=~(label_hash(t["ids"], -1) & 1).bool())
    b3 = _kernel_row(torch, "fused_move", t,
                     lambda: rt.ops.fused_move(*_move_args(t), 0),
                     lambda: _plain_rows(torch, rt.ref, "fused_move", t, 0),
                     2, _argmax_work(torch, t, "fused_move"))[1]
    b3["frontier_rows"] = int(front.sum())
    return {"fused_move": b3, **_time_split(torch, rt, t, plain_reps=2)}


def _road_stream(torch, rt, dev, g, fused):
    """grid2d(3500) under three rounds of road edits through
    StreamSession.update (tile fused, warm with the frontier), each equal
    to the solo warm fit on the card, with a cold fit beside it."""
    from repro_torch.core.delta import affected_frontier, apply_delta
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.launch.stream import StreamSession
    side = ROAD_SIDE
    cfg = dict(backend="tile", split="lp")
    t0 = time.perf_counter()
    base = g.to("cpu")
    download_s = time.perf_counter() - t0
    solo_eng = Engine(EngineConfig(**cfg), cache=PlanCache())
    rng = np.random.default_rng(0)
    used = np.zeros(0, np.int64)
    rounds, total = [], dict.fromkeys(LPA_KERNELS, 0)
    with StreamSession(Engine(EngineConfig(**cfg), cache=PlanCache()),
                       max_batch=1, batch_timeout_ms=0.0) as sess:
        first, add_wall = _wall(torch, lambda: sess.add("road", base))
        check(_same_fit(first, fused), "stream: the session's first fit != "
              "the main phase's fused tile fit")
        for r in range(ROAD_ROUNDS):
            before, prev = sess.graph("road"), sess.labels("road")
            t0 = time.perf_counter()
            delta, used = _road_delta(rng, before, used, side,
                                      ROAD_DELTA_EDGES)
            delta_s = time.perf_counter() - t0
            front = affected_frontier(delta, before.n)
            res, wall, launches = _launched(
                torch, rt, lambda: sess.update("road", delta))
            for k in LPA_KERNELS:
                total[k] += launches[k]
            post = sess.graph("road")
            splice_s = sess.streams["road"].splice_seconds
            post_dev, upload_s = _wall(torch, lambda: post.to(dev))
            solo, solo_wall, solo_launches = _launched(
                torch, rt, lambda: solo_eng.fit(post, init_labels=prev,
                                                init_active=front))
            check(res.warm_started and _same_fit(res, solo),
                  f"stream road round {r}: the update != the solo warm fit")
            frac = res.check_connected(post_dev)
            check(frac == 0.0, f"stream road round {r}: disconnected "
                  f"fraction {frac}")
            cold, cold_wall, cold_launches = _launched(
                torch, rt, lambda: solo_eng.fit(post))
            row = {"round": r, "delta_build_s": delta_s,
                   "insertions": delta.num_insertions,
                   "deletions": delta.num_deletions,
                   "frontier_share": float(front.sum()) / post.n,
                   "splice_s": splice_s, "upload_s": upload_s,
                   "update": _fit_line(res, wall, launches,
                                       fit_s=wall - splice_s),
                   "solo_warm": _fit_line(solo, solo_wall, solo_launches),
                   "cold": _fit_line(cold, cold_wall, cold_launches),
                   "disconnected_fraction": frac}
            if r == 0:
                rebuilt, rebuild_s = _wall(torch,
                                           lambda: apply_delta(before, delta))
                check(_same_graph(rebuilt, post), "stream: the patched graph "
                      "!= apply_delta's rebuild")
                row.update(rebuild_s=rebuild_s, patch_equals_rebuild=True)
                del rebuilt
                row["kernels_first_sweep"] = _frontier_sweep(
                    torch, rt, post_dev, solo.bucket[0], solo.bucket[2],
                    prev, front, dev)
            rounds.append(row)
            del post_dev
        stats = sess.stats()
    check(stats["updates"] == stats["warm_updates"] == ROAD_ROUNDS,
          f"stream road: {stats}")
    for k in ("fused_move", "fused_split"):
        check(total[k] > 0, f"stream road: {k} was not launched")
    return total, {
        "graph": "grid2d(3500)", "n": base.n,
        "directed_edges": base.num_edges,
        "delta": f"{ROAD_DELTA_EDGES} random existing edges deleted, "
                 f"{ROAD_DELTA_EDGES} diagonals inserted, seed 0",
        "backend": "tile fused", "split": "lp",
        "download_base_s": download_s, "session_first_fit_wall_s": add_wall,
        "rounds": rounds, "launches": total}


def _batched_streams(torch, rt):
    """8 planted_partition streams, 3 rounds of evolving_sequence deltas,
    through one StreamSession(max_batch=8).update_many, warm and cold;
    each member equals its solo fit."""
    from repro_torch.core.delta import affected_frontier, apply_delta
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import evolving_sequence, planted_partition
    from repro_torch.launch.stream import StreamSession
    t0 = time.perf_counter()
    traces = [evolving_sequence(0, 0.0, rounds=3, delta_edges=256,
                                seed=100 + s,
                                base=planted_partition(32, 512, 0.04, 0.0005,
                                                       seed=s)[0])
              for s in range(8)]
    build_s = time.perf_counter() - t0
    solo = Engine(EngineConfig(split="lp"), cache=PlanCache())
    out = {"members": "planted_partition(32, 512, 0.04, 0.0005, seed=s), "
                      "s = 0..7; evolving_sequence(rounds=3, "
                      "delta_edges=256, seed=100 + s)",
           "trace_build_s": build_s}
    for warm in (True, False):
        eng = Engine(EngineConfig(split="lp"), cache=PlanCache())
        walls, splices, stages, backends = [], [], [], set()
        with StreamSession(eng, warm=warm, max_batch=8,
                           batch_timeout_ms=20.0) as sess:
            res0 = sess.add_many({s: b for s, (b, _) in enumerate(traces)})
            graphs = {s: b for s, (b, _) in enumerate(traces)}
            prev = {s: r.labels for s, r in res0.items()}
            for r in range(3):
                deltas = {s: ds[r] for s, (_, ds) in enumerate(traces)}
                res, wall = _wall(torch, lambda: sess.update_many(deltas))
                walls.append(wall)
                splices.append(sum(sess.streams[s].splice_seconds
                                   for s in deltas))
                stages.append({k: sum(x.timings[k] for x in res.values())
                               for k in res[0].timings})
                for s, d in deltas.items():
                    graphs[s] = apply_delta(graphs[s], d)
                    kw = dict(init_labels=prev[s], init_active=
                              affected_frontier(d, graphs[s].n)) \
                        if warm else {}
                    want = solo.fit(graphs[s], **kw)
                    check(_same_fit(res[s], want) and res[s].warm_started
                          == warm, f"stream batched warm={warm} round {r}: "
                          f"member {s} != its solo fit")
                    backends.add(res[s].backend)
                    prev[s] = res[s].labels
            stats = sess.stats()
        check(stats["updates"] == 24 and stats["warm_updates"]
              == (24 if warm else 0), f"stream batched: {stats}")
        out["warm" if warm else "cold_replay"] = {
            "update_many_wall_s": walls, "wall_sum_s": sum(walls),
            "splice_sum_s": splices, "fit_many_stage_s": stages,
            "backends": sorted(backends),
            "mean_frontier_share": stats["mean_frontier_frac"],
            "batch_size_hist": stats["batch_size_hist"],
            "updates": stats["updates"],
            "warm_updates": stats["warm_updates"]}
    return out


def _warm_auto(torch):
    """warm_start='auto': a second fit of a graph is warm and equals the
    fit from the first's labels; the cache holds one entry per structure
    and stays at its bound over warm_cache_size + 1 graphs."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import erdos_renyi, planted_partition
    g = planted_partition(32, 512, 0.04, 0.0005, seed=0)[0]
    eng = Engine(EngineConfig(split="lp", warm_start="auto"),
                 cache=PlanCache())
    first, second = eng.fit(g), eng.fit(g)
    want = Engine(EngineConfig(split="lp"), cache=PlanCache()).fit(
        g, init_labels=first.labels)
    check(not first.warm_started and second.warm_started
          and _same_fit(second, want), "stream: auto warm start != the fit "
          "from the first fit's labels")
    check(eng.stats()["warm_entries"] == 1, f"stream: {eng.stats()}")
    cap = eng.config.warm_cache_size
    for i in range(cap + 1):
        eng.fit(erdos_renyi(300 + i, 4.0, seed=i))
        check(eng.stats()["warm_entries"] <= cap, "stream: the warm cache "
              "grew past its bound")
    st = eng.stats()
    check(st["warm_entries"] == cap and st["warm_evictions"] == 2
          and not eng.fit(g).warm_started, f"stream: warm cache {st}")
    return {"graph": "planted_partition(32, 512, 0.04, 0.0005, seed=0)",
            "second_fit_warm": True, "lpa_iterations_cold_warm":
                [first.lpa_iterations, second.lpa_iterations],
            "distinct_graphs": cap + 2, "warm_cache": st}


def phase_stream(torch, rt, dev, g, fused):
    launches, road = _road_stream(torch, rt, dev, g, fused)
    return launches, {"road": road, "batched": _batched_streams(torch, rt),
                      "warm_auto": _warm_auto(torch)}


# ---------------------------------------------------------------- ingest

def _mapped_ranges(path: Path) -> list[tuple[int, int]]:
    out = []
    with open("/proc/self/maps") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 6 and parts[5] == str(path):
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                out.append((lo, hi))
    return out


def phase_ingest(torch, dev, tmp: Path):
    """grid2d(2000) written as MatrixMarket into ``tmp``, ingested by the
    CLI in a subprocess (--stats --detect, on the card), then loaded in
    process twice (parse, store hit) and fitted from its path, cold and
    warm.  Returns the file, the in-core fit(path), its wall and the
    phase's line (the ooc phase reuses the file, the fit and the store in
    ``tmp``)."""
    import os

    from repro_torch.core.delta import undirected_edges
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import grid2d
    from repro_torch.io import load_graph, write_mtx
    old_store = os.environ.get("REPRO_GRAPH_CACHE")
    try:
        g = grid2d(INGEST_SIDE)
        path = tmp / f"grid2d_{INGEST_SIDE}.mtx"
        t0 = time.perf_counter()
        write_mtx(path, undirected_edges(g)[0], n=g.n, symmetric=True)
        write_s = time.perf_counter() - t0
        env = {**os.environ, "REPRO_GRAPH_CACHE": str(tmp / "cli_store"),
               "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.ingest", str(path),
             "--stats", "--detect"], capture_output=True, text=True,
            env=env, timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"ingest CLI exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        check("detect[" in cli.stdout and "cuda" in cli.stdout,
              f"ingest CLI did not detect on the card: {cli.stdout[-2000:]}")

        os.environ["REPRO_GRAPH_CACHE"] = str(tmp / "store")
        g1, rep1 = load_graph(path, return_report=True)
        g2, rep2 = load_graph(path, return_report=True)
        check(not rep1.cache_hit and rep2.cache_hit
              and rep2.parse_seconds == 0.0, "ingest: the second load was "
              "not a store hit")
        for name, h in (("parsed", g1), ("stored", g2)):
            check(_same_graph(g, h), f"ingest: the {name} graph != grid2d")
        ranges = _mapped_ranges((tmp / "store" / rep2.key
                                 / "arrays.bin").resolve())
        copied = not all(any(lo <= getattr(g2, f).data_ptr() < hi
                             for lo, hi in ranges) for f in GRAPH_FIELDS)
        check(not copied, "ingest: the store hit copied its arrays")
        g_dev, upload_s = _wall(torch, lambda: g2.to(dev))
        del g_dev

        want, want_wall = _wall(torch, lambda: Engine(
            cache=PlanCache()).fit(g))
        got, got_wall = _wall(torch, lambda: Engine(
            cache=PlanCache()).fit(str(path)))
        check(got.device.startswith("cuda"), "ingest: fit(path) did not "
              "run on the card")
        check(_same_fit(got, want), "ingest: Engine().fit(path) != "
              "Engine().fit(grid2d)")
        eng = Engine(EngineConfig(warm_start="auto"), cache=PlanCache())
        a, b = eng.fit(str(path)), eng.fit(str(path))
        warm_want = Engine(cache=PlanCache()).fit(g, init_labels=a.labels)
        check(not a.warm_started and b.warm_started
              and _same_fit(b, warm_want), "ingest: the second fit(path) "
              "was not warm through the stored fingerprint")
        return path, got, got_wall, {
            "graph": f"grid2d({INGEST_SIDE})", "n": g.n,
            "undirected_edges": g.num_edges // 2,
            "file_bytes": path.stat().st_size, "write_s": write_s,
            "cli_s": cli_s, "cli_stdout": cli.stdout.splitlines()[-6:],
            "parse_s": rep1.parse_seconds,
            "preprocess_s": rep1.preprocess_seconds,
            "build_s": rep1.build_seconds, "store_write_s": rep1.save_seconds,
            "hash_s": rep1.hash_seconds,
            "repeat_load_s": rep2.load_seconds,
            "repeat_hash_s": rep2.hash_seconds, "repeat_load_copied": copied,
            "upload_from_store_s": upload_s,
            "fit_from_path": {"backend": got.backend, "wall_s": got_wall,
                              "timings_s": got.timings,
                              "lpa_iterations": got.lpa_iterations,
                              "split_iterations": got.split_iterations,
                              "communities": got.num_communities},
            "fit_generated_wall_s": want_wall,
            "warm_second_fit": {"lpa_iterations": b.lpa_iterations,
                                "timings_s": b.timings}}
    finally:
        _restore_env("REPRO_GRAPH_CACHE", old_store)


def _restore_env(name: str, value: str | None) -> None:
    import os
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


# ---------------------------------------------------------------- ooc

def _ooc_line(res, wall, launches, incore_wall):
    """The printed line of one out-of-core fit."""
    o = res.ooc
    return {"partitions": res.partitions, "budget": o["budget"],
            "peak_resident_bytes": o["peak_resident_bytes"],
            "partition_loads": o["partition_loads"],
            "prefetches": o["prefetches"],
            "prefetch_hits": o["prefetch_hits"],
            "halo_cache_hits": o["halo_cache_hits"],
            "halo_cache_bytes_saved": o["halo_cache_bytes_saved"],
            "exchange_bytes": o["exchange_bytes"],
            "halo_vertices": o["halo_vertices"],
            "plan_s": res.timings["prepare"],
            "propagation_s": res.timings["propagation"],
            "split_s": res.timings["split"],
            "compact_s": res.timings["compact"],
            "load_wait_s": o["load_wait_seconds"], "wall_s": wall,
            "in_core_wall_s": incore_wall,
            "wall_over_in_core": wall / incore_wall,
            "lpa_iterations": res.lpa_iterations,
            "split_iterations": res.split_iterations,
            "communities": res.num_communities,
            "launches": launches}


def _ooc_launch_check(launches, res, fused: bool) -> None:
    """One launch of the move and of the split kernel per partition visit,
    none of the other pair."""
    move, split = (("fused_move", "fused_split") if fused
                   else ("label_argmax", "min_label"))
    other = set(LPA_KERNELS) - {move, split}
    p = res.partitions
    check(launches[move] == p * 2 * res.lpa_iterations
          and launches[split] == p * res.split_iterations
          and not any(launches[k] for k in other),
          f"ooc: launches {launches} are not one {move} per partition "
          f"visit ({p} x {2 * res.lpa_iterations}) and one {split} per "
          f"split visit ({p} x {res.split_iterations})")


def phase_ooc(torch, rt, dev, g, main_fused, main_res, path, path_fit,
              path_wall, tmp: Path):
    """Out-of-core fits on the card (A9).

    (a) grid2d(3500) under a budget of 3/4 of its in-core edge bytes
    (13 B per slot), tile fused and unfused, launch counts reset just
    before and read just after each: equal to main's in-core fits (labels,
    both iteration counts), no disconnected community, peak within the
    budget, B3 / B4 (fused) or B1 / B2 (unfused) once per partition visit.
    (b) The fused fit again with the prefetch worker off and
    profile="full": the labels of (a)'s fused fit (prefetch on), and the
    propagation curve of an in-core profiled fused fit.  (c) A real-weight
    segment fit out of core against the in-core segment fit.  (d) The
    ingest phase's file: the CLI with --ooc in a subprocess, and
    Engine().fit(path, memory_budget=...) in process with
    EntryHandle.to_graph disabled (windows only), both equal to the
    in-core fit(path).
    """
    import os

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import weighted_planted_partition
    from repro_torch.io.store import EntryHandle
    from repro_torch.partition.ooc import (
        IN_CORE_EDGE_BYTES,
        fit_out_of_core,
        open_source,
    )
    g_host = g.to("cpu")
    in_core = g.m_pad * IN_CORE_EDGE_BYTES
    budget = in_core * 3 // 4
    # in-core walls with plans built, beside main's cold ones
    warm = {}
    for name, fuse in (("fused", "auto"), ("unfused", "off")):
        eng = Engine(EngineConfig(backend="tile", split="lp",
                                  fuse_sweeps=fuse), cache=PlanCache())
        eng.fit(g)
        warm[name] = _wall(torch, lambda: eng.fit(g))[1]
    lines = {"in_core_warm_wall_s": warm}

    def road_fit(fuse):
        eng = Engine(EngineConfig(backend="tile", split="lp",
                                  fuse_sweeps=fuse), cache=PlanCache())
        return _launched(torch, rt, lambda: eng.fit(
            g_host, memory_budget=budget))

    for fuse in ("auto", "off"):
        res, wall, launches = road_fit(fuse)
        name = "fused" if fuse == "auto" else "unfused"
        # main's fused and unfused in-core fits are equal (phase main)
        check(_same_fit(res, main_fused), f"ooc: the {name} road fit != "
              f"main's in-core fit")
        check(4 <= res.partitions <= 16, f"ooc: {res.partitions} "
              f"partitions, not 4 to 16")
        check(res.ooc["peak_resident_bytes"] <= budget,
              f"ooc: peak {res.ooc['peak_resident_bytes']} > {budget}")
        check(res.device.startswith("cuda"), "ooc: not on the card")
        _ooc_launch_check(launches, res, fused=fuse == "auto")
        lines[name] = {**_ooc_line(res, wall, launches,
                                   main_res[name]["wall_s"]),
                       "wall_over_in_core_warm": wall / warm[name]}
        if fuse == "auto":
            fused = res
    frac = fused.check_connected(g)
    check(frac == 0.0, f"ooc: disconnected fraction {frac}")

    # prefetch off + profiled: fused's labels, the in-core curve
    cfg = EngineConfig(backend="tile", split="lp", profile="full")
    run, wall, launches = _launched(torch, rt, lambda: fit_out_of_core(
        open_source(g_host), cfg, memory_budget=budget, prefetch=False))
    labels = np.unique(run.labels, return_inverse=True)[1]
    check(np.array_equal(labels, fused.labels)
          and (run.lpa_iterations, run.split_iterations)
          == (fused.lpa_iterations, fused.split_iterations)
          and run.prefetches == 0, "ooc: prefetch off != prefetch on")
    check(run.peak_resident_bytes <= budget, "ooc: peak over the budget")
    incore_prof = Engine(cfg, cache=PlanCache()).fit(g)
    check(_same_phase(run.profile.propagation,
                      incore_prof.profile.propagation),
          "ooc: the profiled propagation curve != the in-core curve")
    lines["fused_prefetch_off_profiled"] = {
        "partitions": run.num_partitions, "wall_s": wall,
        "plan_s": run.plan_seconds, "propagation_s": run.lpa_seconds,
        "split_s": run.split_seconds, "prefetches": run.prefetches,
        "load_wait_s": run.load_wait_seconds,
        "peak_resident_bytes": run.peak_resident_bytes,
        "partition_loads": run.partition_loads,
        "halo_cache_hits": run.halo_cache_hits, "launches": launches,
        "propagation_rows": run.profile.propagation.num_sub_sweeps}
    del g_host, run, labels

    # the segment path, real weights
    gw = weighted_planted_partition(40, 500, 0.05, 0.001, seed=3)
    seg = Engine(EngineConfig(backend="segment", split="lp"),
                 cache=PlanCache())
    want, want_wall = _wall(torch, lambda: seg.fit(gw))
    seg_budget = gw.m_pad * IN_CORE_EDGE_BYTES // 3
    res, wall = _wall(torch, lambda: seg.fit(gw, memory_budget=seg_budget))
    check(res.partitions > 1 and _same_fit(res, want)
          and res.backend == "segment", "ooc: the segment fit != in core")
    lines["segment"] = {"graph": "weighted_planted_partition(40, 500, "
                        "0.05, 0.001, seed=3)", "n": gw.n,
                        **_ooc_line(res, wall, {}, want_wall)}

    # from the store: the CLI and fit(path), windows only
    old_store = os.environ.get("REPRO_GRAPH_CACHE")
    os.environ["REPRO_GRAPH_CACHE"] = str(tmp / "store")
    try:
        src = open_source(str(path))
        path_fit_budget = src.m_pad * IN_CORE_EDGE_BYTES * 3 // 4
        handle_budget = str(path_fit_budget)
        report = tmp / "ooc_report.json"
        env = {**os.environ,
               "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.ingest", str(path),
             "--ooc", "--memory-budget", handle_budget, "--json",
             str(report)], capture_output=True, text=True, env=env,
            timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0, f"ingest --ooc exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        rep = json.loads(report.read_text())[0]["ooc"]
        check(rep["partitions"] > 1
              and rep["peak_resident_bytes"] <= path_fit_budget
              and rep["communities"] == path_fit.num_communities
              and (rep["lpa_iterations"], rep["split_iterations"])
              == (path_fit.lpa_iterations, path_fit.split_iterations),
              f"ingest --ooc != the in-core fit(path): {rep}")
        to_graph = EntryHandle.to_graph

        def windows_only(self):
            raise AssertionError("the out-of-core path built the graph")

        EntryHandle.to_graph = windows_only
        try:
            res, wall = _wall(torch, lambda: Engine(cache=PlanCache()).fit(
                str(path), memory_budget=path_fit_budget))
        finally:
            EntryHandle.to_graph = to_graph
        check(res.partitions > 1 and _same_fit(res, path_fit),
              "ooc: fit(path) out of core != the in-core fit(path)")
    finally:
        _restore_env("REPRO_GRAPH_CACHE", old_store)
    lines["store"] = {
        "graph": f"grid2d({INGEST_SIDE}) from its .mtx store entry",
        "cli_s": cli_s, "cli_stdout": cli.stdout.splitlines()[-2:],
        "cli_report": {k: rep[k] for k in (
            "backend", "partitions", "budget", "peak_resident_bytes",
            "partition_loads", "prefetch_hits", "plan_seconds",
            "lpa_seconds", "split_seconds")},
        **_ooc_line(res, wall, {}, path_wall)}
    return {"graph": "grid2d(3500)", "in_core_edge_bytes": in_core,
            "budget": budget, **lines}


# ---------------------------------------------------------------- timing

def _time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timing_tiles(torch, g, rows, d, labels_np, dev):
    """Tiles and per-row state of one timing call: the graph's padded
    tiles at (rows, d), ``labels_np`` on its vertices (ids beyond), the
    hashed parity class as klass, every row active, 10 % changed."""
    from repro_torch.core.graph import to_padded_neighbors
    from repro_torch.kernels.ref import label_hash
    nbr, nw, nmask = to_padded_neighbors(g, d_max=d, rows=rows)
    ids = torch.arange(rows, dtype=torch.int32, device=dev)
    labels = ids.clone()
    labels[: g.n] = torch.from_numpy(np.asarray(labels_np)).to(dev)
    rng = np.random.default_rng(0)
    return {"nbr": nbr, "nw": nw, "nmask": nmask, "labels": labels,
            "ids": ids,
            "chg": torch.from_numpy(rng.random(rows) < 0.1).to(dev),
            "active": torch.ones(rows, dtype=torch.bool, device=dev),
            "cand_prev": torch.zeros(rows, dtype=torch.bool, device=dev),
            "klass": (label_hash(ids, -1) & 1).bool(), "real": ids < g.n}


def _move_args(t, nw=None):
    return (t["nbr"], t["nw"] if nw is None else nw, t["nmask"], t["labels"],
            t["chg"], t["active"], t["cand_prev"], t["klass"], t["real"])


def _plain_rows(torch, ref, name, t, seed):
    """The plain version of B1 / B3 over row chunks whose D x D equality
    cube stays within 1 GiB of float32.  The plain version reads
    ``labels[:rows]`` as the rows' own labels, so each chunk's labels (and
    changed flags) go first and its nbr is shifted past them."""
    fn = {"label_argmax": ref.label_argmax_ref,
          "fused_move": ref.fused_move_ref}[name]
    rows, d = t["nbr"].shape
    step = max(1, PLAIN_CUBE_FLOATS // (d * d))
    if step >= rows:
        args = (_move_args(t) if name == "fused_move"
                else (t["nbr"], t["nw"], t["nmask"], t["labels"]))
        return fn(*args, seed)
    outs = []
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        nbr = t["nbr"][lo:hi] + (hi - lo)
        lab = torch.cat([t["labels"][lo:hi], t["labels"]])
        tile = (nbr, t["nw"][lo:hi], t["nmask"][lo:hi], lab)
        if name == "fused_move":
            chg = torch.cat([t["chg"][lo:hi], t["chg"]])
            tile += (chg, *(t[k][lo:hi] for k in ("active", "cand_prev",
                                                  "klass", "real")))
        outs.append(fn(*tile, seed))
    return tuple(torch.cat(x) for x in zip(*outs))


def _bits_check(torch, rt, t, dev, seed=3):
    """B1 and B3 on real weights (uniform(0.1, 5.0) on the real cells, from
    a seed) against the slot-order sum (``ref.label_argmax_slot_order``),
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    nw = torch.empty(t["nw"].shape, device=dev).uniform_(0.1, 5.0,
                                                          generator=gen)
    nw = torch.where(t["nmask"], nw, 0.0)
    got = rt.ops.label_argmax(t["nbr"], nw, t["nmask"], t["labels"], seed)
    want = rt.ref.label_argmax_slot_order(t["nbr"], nw, t["nmask"],
                                          t["labels"], seed)
    for a, b, what in zip(got, want, ("best_lab", "best_w", "cur_w")):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"label_argmax {what} != the slot-order sum's bits "
              f"(d={t['nbr'].shape[1]})")
    new, act = rt.ops.fused_move(*_move_args(t, nw), seed)
    bl, bw, cw = want
    wake = (t["chg"][t["nbr"]] & t["nmask"]).any(dim=1)
    act_want = (t["active"] & ~t["cand_prev"]) | (wake & t["real"])
    adopt = act_want & t["klass"] & (bw > cw.clamp_min(0.0))
    check(torch.equal(act, act_want)
          and torch.equal(new, torch.where(adopt, bl, t["labels"])),
          f"fused_move != the slot-order sum + glue "
          f"(d={t['nbr'].shape[1]})")
    return {"weights": "uniform(0.1, 5.0)", "bits_equal": True,
            "rows_adopting": int(adopt.sum())}


def _argmax_work(torch, t, name):
    """(bytes, bytes_all_rows, operations) of one B1 / B3 call on ``t``.

    Bytes: what a correct kernel must move, each input read once and each
    output written once.  B1 reads every row: the mask tile, nbr and
    weight of each real cell, the label vector, and writes 12 B per row.
    B3 reads each row's 4 state bytes and its label and writes 5 B; only
    rows whose act needs the wake (not active && !cand_prev, and real)
    add their mask row, their real cells' nbr and the changed vector, and
    only rows that can adopt (act && klass) add mask, nbr and weights.
    ``bytes_all_rows`` is the earlier model that counts every row's tile.
    Operations: at least r * ceil(log2 r) compares per row that needs an
    argmax (a sort of its r real labels), counted at the fp32 rate.
    """
    nbr, nmask = t["nbr"], t["nmask"]
    rows, d = nmask.shape
    n_vec = t["labels"].numel()
    r = nmask.sum(dim=1)
    cells = int(r.sum())

    def compares(sel):
        rr = r[sel].double()
        return float((rr * torch.ceil(torch.log2(rr.clamp_min(1)))).sum())

    if name == "label_argmax":
        b = rows * d + 8 * cells + 4 * n_vec + 12 * rows
        return b, b, compares(torch.ones_like(nmask[:, 0]))
    known = t["active"] & ~t["cand_prev"]
    wake_rows = ~known & t["real"]
    wake = (t["chg"][nbr] & nmask).any(dim=1)
    arg_rows = (known | (wake & t["real"])) & t["klass"]
    touched = wake_rows | arg_rows
    b = (9 * rows + 4 * n_vec + int(touched.sum()) * d
         + 4 * int(r[touched].sum()) + 4 * int(r[arg_rows].sum())
         + (n_vec if bool(wake_rows.any()) else 0))
    all_rows = rows * d + cells * 8 + 5 * n_vec + 4 * rows + 5 * rows
    return b, all_rows, compares(arg_rows)


def _kernel_row(torch, name, t, kern, plain, plain_reps, work):
    """Check a kernel against its plain version exactly, time both, and
    hold the kernel to its bound (``work`` = bytes, bytes_all_rows,
    operations)."""
    ka, pa = kern(), plain()
    ka = ka if isinstance(ka, tuple) else (ka,)
    pa = pa if isinstance(pa, tuple) else (pa,)
    err = max(_err(a, b) for a, b in zip(ka, pa))
    rows, d = t["nbr"].shape
    check(err == 0.0, f"{name} disagrees with its plain version at "
          f"({rows}, {d}): {err}")
    ms = _time_ms(torch, kern)
    plain_ms = _time_ms(torch, plain, reps=plain_reps, warmup=1)
    bytes_, bytes_all, ops_n = work
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / FP32_OPS_PER_S * 1e3
    share = bytes_ms / ms
    check(share <= 1.0, f"{name} at ({rows}, {d}) took {ms} ms, under its "
          f"bytes bound {bytes_ms} ms: the bound's model is wrong")
    return ka, {
        "rows": rows, "d": d, "real_cells": int(t["nmask"].sum()),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_, "bytes_all_rows": bytes_all, "operations": ops_n,
        "achieved_GBps": bytes_ / (ms * 1e-3) / 1e9,
        "bytes_bound_share": share, "library_ms": None}


def _time_argmax(torch, rt, t, plain_reps, seed=3):
    """B1 and B3 on ``t``: exact against the plain version, timed, with
    their bounds."""
    out = {}
    for name in ARGMAX_KERNELS:
        if name == "label_argmax":
            def kern():
                return rt.ops.label_argmax(t["nbr"], t["nw"], t["nmask"],
                                           t["labels"], seed)
        else:
            def kern():
                return rt.ops.fused_move(*_move_args(t), seed)
        out[name] = _kernel_row(
            torch, name, t, kern,
            lambda n=name: _plain_rows(torch, rt.ref, n, t, seed),
            plain_reps, _argmax_work(torch, t, name))[1]
    return out


def _split_work(t, prune):
    """(bytes, bytes_all_rows, operations) of one B2 / B4 call on ``t``:
    the mask tile, the nbr of each real cell, the label and community
    vectors, 4 B out per row, and with prune the changed vector; one
    compare per real cell."""
    rows, d = t["nmask"].shape
    cells = int(t["nmask"].sum())
    b = rows * d + 4 * cells + 8 * rows + 4 * rows
    if prune:
        b += t["chg"].numel()
    return b, b, cells


def _time_split(torch, rt, t, plain_reps):
    """B2 and B4 on ``t`` as a split's first sweep (labels = row ids, comm
    = the case's labels): exact against the plain version, timed, with
    their bounds; B4 without prune (split lp) and with it (lpp)."""
    ops, ref = rt.ops, rt.ref
    nbr, nmask, ids, comm, chg = (t[k] for k in ("nbr", "nmask", "ids",
                                                 "labels", "chg"))
    mins = ops.min_label(nbr, nmask, ids, comm)
    check(torch.equal(ops.fused_split(nbr, nmask, ids, comm, chg, False),
                      mins), "fused_split without prune != min_label")
    runs = {"min_label": (lambda: ops.min_label(nbr, nmask, ids, comm),
                          lambda: ref.min_label_ref(nbr, nmask, ids, comm),
                          False)}
    for name, p in (("fused_split", False), ("fused_split_prune", True)):
        runs[name] = (
            lambda p=p: ops.fused_split(nbr, nmask, ids, comm, chg, p),
            lambda p=p: ref.fused_split_ref(nbr, nmask, ids, comm, chg, p),
            p)
    return {name: _kernel_row(torch, name, t, kern, plain, plain_reps,
                              _split_work(t, prune))[1]
            for name, (kern, plain, prune) in runs.items()}


def phase_timing(torch, rt, dev, cases):
    """``cases``: (graph name, graph, rows, d, labels) per width, the main
    fit's first."""
    ops = rt.ops
    widths = []
    for gname, g, rows, d, labels in cases:
        t = _timing_tiles(torch, g, rows, d, labels, dev)
        torch.cuda.synchronize()
        row = {"graph": gname, "rows": rows, "d": d,
               "real_cells": int(t["nmask"].sum()),
               "real_weight_check": _bits_check(torch, rt, t, dev)}
        reps = 5 if d <= 8 else 2
        row.update(_time_argmax(torch, rt, t, plain_reps=reps))
        row.update(_time_split(torch, rt, t, plain_reps=reps))
        if not widths:
            main_t = t
        else:
            del t
        widths.append(row)
    t = main_t
    ids, rows = t["ids"], t["nbr"].shape[0]
    # B3 at the main shapes with klass on every row, and on the first half
    # of the rows (as many rows as the parity class, but contiguous): how
    # far the parity class's interleaved rows keep the tile's bytes read
    layouts = {}
    for tag, kl in (("parity", t["klass"]), ("all_rows", ids >= 0),
                    ("first_half", ids < rows // 2)):
        tk = {**t, "klass": kl}
        layouts[tag] = {
            "rows_in_klass": int(kl.sum()),
            "ms": _time_ms(torch, lambda tk=tk: ops.fused_move(
                *_move_args(tk), 3)),
            "bytes": _argmax_work(torch, tk, "fused_move")[0]}
    # the main fit's split is lp: fused_split without prune
    main = {k: widths[0][k] for k in LPA_KERNELS}
    return {"kernels": main, "widths": widths,
            "fused_move_klass_layouts": layouts}


# ----------------------------------------------------------------- trace

def phase_trace(torch, g):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Engine, EngineConfig, PlanCache
    eng = Engine(EngineConfig(backend="tile", split="lp"), cache=PlanCache())
    eng.fit(g)   # plan and allocator warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.fit(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_s = busy * 1e-6
    top = sorted(((a.key, a.self_device_time_total * 1e-6, a.count)
                  for a in prof.key_averages()
                  if a.self_device_time_total > 0),
                 key=lambda x: -x[1])[:8]
    return {"fit": "fused tile fit of grid2d(3500), plan warm",
            "wall_s": wall, "timings_s": res.timings,
            "device_events": len(spans), "device_busy_s": busy_s,
            "device_idle_share": (1.0 - busy_s / wall) if spans else None,
            "top_device": [{"name": k[:80], "s": s, "count": c}
                           for k, s, c in top]}


# ----------------------------------------------------------------- flash

def _qkv(torch, gen, b, sq, h, k, hd, skv, dtype):
    def rnd(*shape):
        return torch.randn(shape, device=gen.device, generator=gen).to(dtype)
    return rnd(b, sq, h, hd), rnd(b, skv, k, hd), rnd(b, skv, k, hd)


def _rel(got, want) -> tuple[float, float]:
    """(max abs difference, that over max abs of the plain version)."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / float(want.float().abs().max())


def phase_flash(torch, rt, dev):
    ops, ref = rt.ops, rt.ref
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 8e-3, f32: 1e-5}      # one bf16 ulp; f32 sums reordered
    gen = torch.Generator(device=dev).manual_seed(0)
    # (b, sq, h, k, hd, skv, causal, dtype): the reference's test shapes
    # (tests/test_flash_attention.py), causal and not, then ragged, cross,
    # Sq > Skv under causal, and float32.
    cases = [(b, s, h, k, hd, s, c, bf16)
             for b, s, h, k, hd in ((1, 256, 4, 4, 64), (2, 512, 8, 2, 64),
                                    (1, 512, 4, 1, 128))
             for c in (True, False)]
    cases += [(1, 300, 4, 4, 64, 300, True, bf16),
              (1, 256, 4, 4, 64, 512, False, bf16),
              (1, 300, 2, 2, 64, 200, True, bf16),
              (1, 1024, 2, 2, 64, 1024, True, bf16),
              (1, 256, 2, 2, 64, 256, True, f32),
              (1, 300, 2, 2, 64, 200, True, f32),
              (1, 512, 4, 1, 128, 512, False, f32),
              (2, 300, 8, 2, 128, 333, True, f32)]
    # The TMA ring's edges: a ragged Skv at B=2 (no tile may read into the
    # next batch), several partial KV tiles, a 128-byte row (hd=64), one
    # query.
    cases += [(2, 300, 8, 2, 128, 333, True, bf16),
              (1, 1000, 4, 1, 128, 1000, True, bf16),
              (1, 512, 4, 1, 64, 512, False, bf16),
              (2, 1, 4, 2, 128, 77, False, bf16)]
    checked = []
    for b, sq, h, k, hd, skv, causal, dtype in cases:
        q, kk, v = _qkv(torch, gen, b, sq, h, k, hd, skv, dtype)
        got = ops.flash_attention(q, kk, v, causal=causal)
        want = ref.flash_attention_ref(q, kk, v, causal)
        abs_err, rel = _rel(got, want)
        name = str(dtype).replace("torch.", "")
        check(got.dtype == dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all()),
              f"flash output malformed at {(b, sq, h, k, hd, skv)}")
        check(rel < tol[dtype], f"flash disagrees with its plain version: "
              f"{(b, sq, h, k, hd, skv, causal, name)} rel {rel}")
        checked.append({"shape": [b, sq, h, k, hd, skv], "causal": causal,
                        "dtype": name, "max_abs_err": abs_err,
                        "rel_err": rel})

    # The main path: one causal prefill call at Yi-9B's attention width.
    b, s, h, k, hd = (FLASH_MAIN[x] for x in ("b", "s", "h", "k", "hd"))
    q, kk, v = _qkv(torch, gen, b, s, h, k, hd, s, bf16)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = ops.flash_attention(q, kk, v, causal=True)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_attention"]
    check(launches == 1, f"the main call made {launches} flash launches")
    check(out.shape == q.shape and bool(torch.isfinite(out).all()),
          "flash main call: malformed output")
    want = ref.flash_attention_ref(q, kk, v, True)
    abs_err, rel = _rel(out, want)
    check(rel < tol[bf16], f"flash main call disagrees: rel {rel}")

    plain_ms = _time_ms(torch, lambda: ref.flash_attention_ref(q, kk, v,
                                                               True),
                        reps=3, warmup=1)
    main = _flash_timed(torch, ops, q, kk, v, True, want)
    main.update({"shape": FLASH_MAIN, "dtype": "bfloat16", "causal": True,
                 "launches": launches, "max_abs_err": abs_err,
                 "rel_err": rel, "plain_ms": plain_ms})
    del q, kk, v, out, want
    timed = []
    for seq, causal in FLASH_TIMED:
        # Checked against the plain version too: the non-causal loop and
        # the 16384-token grid are reached at this width only.
        q, kk, v = _qkv(torch, gen, b, seq, h, k, hd, seq, bf16)
        got = ops.flash_attention(q, kk, v, causal=causal)
        abs_err, rel = _rel(got, ref.flash_attention_ref(q, kk, v, causal))
        check(bool(torch.isfinite(got).all()) and rel < tol[bf16],
              f"flash disagrees at S={seq} causal={causal}: rel {rel}")
        row = _flash_timed(torch, ops, q, kk, v, causal)
        timed.append({"shape": {**FLASH_MAIN, "s": seq}, "causal": causal,
                      "max_abs_err": abs_err, "rel_err": rel, **row})
        del q, kk, v, got
    return {"cases": checked,
            "tolerance_rel": {"bfloat16": 8e-3, "float32": 1e-5},
            "main": main, "timed": timed}


def _flash_timed(torch, ops, q, kk, v, causal, want=None):
    """Time one flash call beside SDPA (yardstick only, on the (B, H, S,
    hd) layout), with its work and bound; SDPA's error if `want` given."""
    b, sq, h, hd = q.shape
    skv = kk.shape[1]
    ms = _time_ms(torch, lambda: ops.flash_attention(q, kk, v,
                                                     causal=causal))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, v))
    row = {"ms": ms}
    if want is not None:
        lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        row["library_max_abs_err"], row["library_rel_err"] = _rel(
            lib_out.transpose(1, 2), want)
        del lib_out
    row["library_ms"] = _time_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    # Work the call needs: QK^T and PV over the visible (query, key)
    # pairs; q, k, v read once and the output written once.
    rows = np.arange(1, sq + 1)
    pairs = int(np.minimum(rows, skv).sum()) if causal else sq * skv
    operations = 4 * b * h * hd * pairs
    bytes_ = (2 * q.numel() + kk.numel() + v.numel()) * 2
    ops_ms = operations / BF16_OPS_PER_S * 1e3
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row.update({"operations": operations, "bytes": bytes_,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "achieved_TFLOPs": operations / (ms * 1e-3) / 1e12})
    return row


# ------------------------------------------------------------------ main

def _parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all); the "
                    "kernels summary and the result line print only when "
                    "all ran")
    args = ap.parse_args(argv)
    args.phases = [x for x in args.phases.split(",") if x]
    for name in args.phases:
        if name not in PHASES:
            ap.error(f"unknown phase {name!r}; phases: {', '.join(PHASES)}")
        for need in NEEDS.get(name, ()):
            if need not in args.phases:
                ap.error(f"phase {name} needs phase {need}")
    return args


def main(argv=None) -> int:
    args = _parse_args(argv)
    run = set(args.phases)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from types import SimpleNamespace

    from repro_torch.kernels import build, ops, ref
    rt = SimpleNamespace(ops=ops, ref=ref)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain argmax sums
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": platform.python_version()})

    t0 = time.perf_counter()
    build.load_library()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          **build.BUILD_INFO})
    resources = build.BUILD_INFO["resources"]
    # every instance of the split kernels (min_label_narrow<4>, ...)
    no_spill = [n for n in resources
                if n in FLASH_KERNELS or n.startswith(SPLIT_KERNELS)]
    for prefix in (*FLASH_KERNELS, *SPLIT_KERNELS):
        check(any(n.startswith(prefix) for n in no_spill),
              f"ptxas reports no entry for {prefix}")
    for name in no_spill:
        res = resources[name]
        check(res.get("registers") and res.get("spill_store_bytes") == 0
              and res.get("spill_load_bytes") == 0,
              f"{name}: ptxas reports a spill or no registers: {res}")
        check("wgmma_serialized" not in res, f"{name}: ptxas serialised "
              f"its wgmma {res.get('wgmma_serialized')}")

    if "kernels" in run:
        res = phase_kernels(torch, ops, ref, dev)
        kernel_err = res["max_abs_err"]
        emit({"phase": "kernels", **res})
    if "parity" in run:
        emit({"phase": "parity", **phase_parity(torch, rt, dev)})
    if "c1" in run:
        emit({"phase": "c1", **phase_c1(torch, dev)})
    if "main" in run:
        g, fused, main_res = phase_main(torch, rt, dev)
        launches = main_res["launches"]
        emit({"phase": "main", **main_res})
    if "wide_fit" in run:
        g_er, fused_er, res = phase_wide_fit(torch, rt, dev)
        emit({"phase": "wide_fit", **res})
    if "dense" in run:
        emit({"phase": "dense", **phase_dense(torch, rt, g_er, dev)})
    if "skew_fit" in run:
        emit({"phase": "skew_fit", **phase_skew_fit(torch, dev)})
    if "batch" in run:
        graphs_a, graphs_b, solo_b, batch_launches, res = phase_batch(
            torch, rt, dev)
        emit({"phase": "batch", **res})
    if "obs" in run:
        obs_launches, res = phase_obs(torch, rt, dev, g, fused, graphs_a,
                                      graphs_b)
        del graphs_a
        emit({"phase": "obs", **res})
    if "microbatch" in run:
        emit({"phase": "microbatch",
              **phase_microbatch(torch, graphs_b, solo_b)})
    if "stream" in run:
        stream_launches, res = phase_stream(torch, rt, dev, g, fused)
        emit({"phase": "stream", **res})
    if "ingest" in run:
        import shutil
        import tempfile
        ingest_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ingest_"))
        try:
            mtx, path_fit, path_wall, res = phase_ingest(torch, dev,
                                                         ingest_tmp)
            emit({"phase": "ingest", **res})
            if "ooc" in run:
                rt.ops.reset_launches()
                res = phase_ooc(torch, rt, dev, g, fused, main_res, mtx,
                                path_fit, path_wall, ingest_tmp)
                ooc_launches = {k: res["fused"]["launches"][k]
                                + res["unfused"]["launches"][k]
                                for k in LPA_KERNELS}
                emit({"phase": "ooc", **res})
        finally:
            shutil.rmtree(ingest_tmp, ignore_errors=True)
    if "timing" in run:
        from repro_torch.engine.bucketing import bucket_for
        from repro_torch.graphgen import planted_partition
        t0 = time.perf_counter()
        g_pp, truth = planted_partition(128, 1024, 0.3, 0.001, seed=0)
        g_pp = g_pp.to(dev)
        pp_build_s = time.perf_counter() - t0
        b_pp = bucket_for(g_pp)
        cases = [("grid2d(3500)", g, fused.bucket[0], fused.bucket[2],
                  fused.labels),
                 (ER_GRAPH, g_er, fused_er.bucket[0], fused_er.bucket[2],
                  fused_er.labels),
                 (PLANTED_GRAPH + ", ground-truth labels", g_pp, b_pp.n,
                  b_pp.d, truth),
                 # a fit's first sweep: every label distinct, all tied
                 (PLANTED_GRAPH + ", labels = vertex ids", g_pp, b_pp.n,
                  b_pp.d, np.arange(g_pp.n, dtype=np.int32))]
        timing = phase_timing(torch, rt, dev, cases)
        del g_er, fused_er, g_pp, cases
        emit({"phase": "timing", "planted_graph_build_s": pp_build_s,
              **timing})
        timing = timing["kernels"]
    if "trace" in run:
        emit({"phase": "trace", **phase_trace(torch, g)})
    if "flash" in run:
        flash = phase_flash(torch, rt, dev)
        emit({"phase": "flash", **flash})
    if run != set(PHASES):
        print("chip_smoke: a subset of the phases ran; no kernels summary "
              "and no result line", file=sys.stderr)
        return 0

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "batch_launches": batch_launches[name],
         "stream_launches": stream_launches[name],
         "obs_launches": obs_launches[name],
         "ooc_launches": ooc_launches[name],
         "launched_by": "launches: tile fits of grid2d(3500), fused and "
                        "unfused; batch_launches: fit_many of traffic A "
                        "(32 grid2d members), tile fused and unfused; "
                        "stream_launches: the 3 warm road updates of "
                        "grid2d(3500) through StreamSession (tile fused); "
                        "obs_launches: profile=\"full\" tile fits of "
                        "grid2d(3500), fused and unfused; ooc_launches: "
                        "out-of-core tile fits of grid2d(3500), fused "
                        "and unfused, one launch per partition visit",
         "max_abs_err": kernel_err[name],
         **{k: timing[name][k] for k in keys}}
        for name in LPA_KERNELS]
    fm = flash["main"]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": KERNELS["flash_attention"][0],
        "replaces": KERNELS["flash_attention"][1],
        "launches": fm["launches"],
        "launched_by": "flash phase: ops.flash_attention at Yi-9B width "
                       "(B=1, S=4096, H=32, K=4, hd=128, bf16, causal)",
        "max_abs_err": fm["max_abs_err"], **{k: fm[k] for k in keys}})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
