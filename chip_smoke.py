#!/usr/bin/env python3
"""Drive the PyTorch port of GSL-LPA on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases main,wide_fit,skew_fit,timing
        # only those phases, and no result line.  The script imports the
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
           no internally-disconnected community.  Launch counts are reset
           just before these fits and read just after.
  wide_fit the same three fits of erdos_renyi(1<<21, 16.0) (2.1M vertices,
           D=64 tiles): identical labels, no disconnected community.
  skew_fit two segment fits of rmat(20, 16) (hubs of degree ~10^4, long
           per-(vertex, label) runs): equal labels, their timings.
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
PHASES = ("kernels", "parity", "c1", "main", "wide_fit", "skew_fit",
          "timing", "trace", "flash")
# phase -> the phases whose graphs and fits it reuses
NEEDS = {"timing": ("main", "wide_fit"), "trace": ("main",)}
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

def _three_fits(torch, rt, g):
    """Tile fused, tile unfused and segment fits (split lp) of ``g``, with
    the launch counts (reset just before the tile fits, read just after)
    and the peak device memory of the tile fits."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache

    def fit(**kw):
        return Engine(EngineConfig(split="lp", **kw), cache=PlanCache()).fit(g)

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
        return {"timings_s": res.timings, "total_s": res.total_seconds,
                "edges_per_s": g.num_edges / res.total_seconds}

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
        g, fused, res = phase_main(torch, rt, dev)
        launches = res["launches"]
        emit({"phase": "main", **res})
    if "wide_fit" in run:
        g_er, fused_er, res = phase_wide_fit(torch, rt, dev)
        emit({"phase": "wide_fit", **res})
    if "skew_fit" in run:
        emit({"phase": "skew_fit", **phase_skew_fit(torch, dev)})
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
         "launched_by": "tile fits of grid2d(3500), fused and unfused",
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
