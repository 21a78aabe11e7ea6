#!/usr/bin/env python3
"""Drive the PyTorch port of GSL-LPA on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card

Phases, one JSON line each:

  device   nvidia-smi name and power limit; torch, CUDA and Python versions.
  build    nvcc build of the CUDA kernels (seconds, registers, spills).
  kernels  each kernel against its plain PyTorch version on random inputs:
           widths D in {1, 4, 16, 128, 1024}, hash seeds {0, 1, 12345, -1},
           edgeless rows and rows whose own label is absent.  Integer
           weights must agree exactly; real weights must satisfy the
           brute-force argmax property at rtol 1e-5; fused and unfused
           kernels must agree bit for bit.
  parity   tile backend (kernels) against segment backend on small graphs,
           every split mode, shortcut, fusion on and off.
  main     Engine.fit of grid2d(3500) (12.25M vertices, 49M directed edges):
           tile fused, tile unfused and segment give identical labels and
           no internally-disconnected community.  Launch counts are reset
           just before these fits and read just after.
  timing   each kernel at the main fit's shapes (CUDA events), its plain
           version, and the HBM bound of its bytes at 3.35 TB/s.
  trace    torch.profiler over one fused fit: top device ops, idle share.

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
KERNELS = {
    "label_argmax": ("src/repro_torch/kernels/csrc/label_argmax.cu",
                     "src/repro/kernels/label_argmax.py:81"),
    "min_label": ("src/repro_torch/kernels/csrc/min_label.cu",
                  "src/repro/kernels/min_label.py:28"),
    "fused_move": ("src/repro_torch/kernels/csrc/fused_move.cu",
                   "src/repro/kernels/fused_sweep.py:65"),
    "fused_split": ("src/repro_torch/kernels/csrc/fused_split.cu",
                    "src/repro/kernels/fused_sweep.py:128"),
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
    widths = (1, 4, 16, 128, 1024)
    seeds = (0, 1, 12345, -1)
    rows_for = {1: 4096, 4: 4096, 16: 4096, 128: 512, 1024: 40}
    err = {k: 0.0 for k in KERNELS}
    cases = 0
    for d in widths:
        rows = rows_for[d]
        ti = _random_case(torch, rows, d, 11, True, dev)
        tr = _random_case(torch, rows, d, 12, False, dev)
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
            for t in (ti, tr):
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
    launches = dict(rt.ops.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched in the parity fits")
    return {"cases": out, "launches": launches}


# ------------------------------------------------------------------ main

def phase_main(torch, rt, dev):
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import grid2d
    t0 = time.perf_counter()
    g = grid2d(3500).to(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def fit(**kw):
        eng = Engine(EngineConfig(split="lp", **kw), cache=PlanCache())
        return eng.fit(g)

    torch.cuda.reset_peak_memory_stats()
    rt.ops.reset_launches()
    fused = fit(backend="tile")
    launches_fused = dict(rt.ops.LAUNCHES)
    unfused = fit(backend="tile", fuse_sweeps="off")
    launches = dict(rt.ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    segment = fit(backend="segment")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the main fits")
    launches_unfused = {k: launches[k] - launches_fused[k] for k in launches}
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

    return g, fused, {
        "graph": "grid2d(3500)", "n": g.n, "directed_edges": g.num_edges,
        "graph_build_s": build_s, "bucket": list(fused.bucket),
        "lpa_iterations": fused.lpa_iterations,
        "split_iterations": fused.split_iterations,
        "communities": fused.num_communities,
        "disconnected_fraction": frac,
        "fused": summary(fused), "unfused": summary(unfused),
        "segment": summary(segment),
        "launches": launches, "launches_fused_fit": launches_fused,
        "launches_unfused_fit": launches_unfused,
        "peak_bytes_tile_fits": peak,
    }


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


def phase_timing(torch, rt, dev, g, fused):
    from repro_torch.core.graph import to_padded_neighbors
    from repro_torch.kernels.ref import label_hash
    ops, ref = rt.ops, rt.ref
    rows, _m, d = fused.bucket
    nbr, nw, nmask = to_padded_neighbors(g, d_max=d, rows=rows)
    ids = torch.arange(rows, dtype=torch.int32, device=dev)
    labels = ids.clone()
    labels[: g.n] = torch.from_numpy(fused.labels).to(dev)
    parity = (label_hash(ids, -1) & 1).bool()
    rng = np.random.default_rng(0)
    chg = torch.from_numpy(rng.random(rows) < 0.1).to(dev)
    active = torch.ones(rows, dtype=torch.bool, device=dev)
    cand_prev = torch.zeros_like(active)
    real = ids < g.n
    cells = int(nmask.sum())
    L = rows
    # Bytes each call must move: the mask tile, nbr / weight of real cells,
    # each per-vertex vector once, each output once.
    bytes_ = {
        "label_argmax": rows * d + cells * 8 + 4 * L + 12 * rows,
        "min_label": rows * d + cells * 4 + 8 * L + 4 * rows,
        "fused_move": rows * d + cells * 8 + 5 * L + 4 * rows + 5 * rows,
        "fused_split": rows * d + cells * 4 + 8 * L + 4 * rows,
    }
    ops_count = {"label_argmax": 2 * cells * d, "fused_move": 2 * cells * d,
                 "min_label": cells, "fused_split": cells}
    calls = {
        "label_argmax": (lambda: ops.label_argmax(nbr, nw, nmask, labels, 3),
                         lambda: ref.label_argmax_ref(nbr, nw, nmask,
                                                      labels, 3)),
        "min_label": (lambda: ops.min_label(nbr, nmask, ids, labels),
                      lambda: ref.min_label_ref(nbr, nmask, ids, labels)),
        "fused_move": (lambda: ops.fused_move(nbr, nw, nmask, labels, chg,
                                              active, cand_prev, parity,
                                              real, 3),
                       lambda: ref.fused_move_ref(nbr, nw, nmask, labels, chg,
                                                  active, cand_prev, parity,
                                                  real, 3)),
        # the main fit's split is lp: no prune, chg not read
        "fused_split": (lambda: ops.fused_split(nbr, nmask, ids, labels, chg,
                                                False),
                        lambda: ref.fused_split_ref(nbr, nmask, ids, labels,
                                                    chg, False)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        ka, pa = kern(), plain()
        err = max(_err(a, b) for a, b in zip(
            ka if isinstance(ka, tuple) else (ka,),
            pa if isinstance(pa, tuple) else (pa,)))
        check(err == 0.0, f"{name} disagrees at the main shapes: {err}")
        ms = _time_ms(torch, kern)
        plain_ms = _time_ms(torch, plain, reps=5, warmup=1)
        bytes_ms = bytes_[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count[name] / FP32_OPS_PER_S * 1e3
        out[name] = {
            "rows": rows, "d": d, "real_cells": cells,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_[name], "operations": ops_count[name],
            "achieved_GBps": bytes_[name] / (ms * 1e-3) / 1e9,
            "library_ms": None,
        }
    return out


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


# ------------------------------------------------------------------ main

def main() -> int:
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

    res = phase_kernels(torch, ops, ref, dev)
    kernel_err = res["max_abs_err"]
    emit({"phase": "kernels", **res})
    emit({"phase": "parity", **phase_parity(torch, rt, dev)})
    g, fused, res = phase_main(torch, rt, dev)
    launches = res["launches"]
    emit({"phase": "main", **res})
    timing = phase_timing(torch, rt, dev, g, fused)
    emit({"phase": "timing", "kernels": timing})
    emit({"phase": "trace", **phase_trace(torch, g)})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launched_by":
             "tile fits of grid2d(3500), fused and unfused",
         "max_abs_err": kernel_err[name],
         **{k: timing[name][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
