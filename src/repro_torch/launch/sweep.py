"""Dry-run sweep driver: one subprocess per cell (memory isolation, and a
fake world of its own: a cell's failure or leak never takes down the
sweep, and no process group outlives its cell).

The port of ``repro.launch.sweep``, over ``repro_torch.launch.dryrun``:

  PYTHONPATH=src python -m repro_torch.launch.sweep [--mesh pod|multipod|both]
      [--force]

Each cell's JSON goes to ``experiments/dryrun_torch/``; a cell whose JSON
is there is skipped unless ``--force``.  A cell that fails or outlasts
``CELL_TIMEOUT_S`` prints the end of its errors, and the sweep exits 1.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
OUT = REPO / "experiments" / "dryrun_torch"
CELL_TIMEOUT_S = 3600


def cells():
    from repro_torch.configs import ARCHS, supported_shapes
    out = []
    for arch, cfg in ARCHS.items():
        for shape in supported_shapes(cfg):
            out.append((arch, shape))
    out.append(("graph-lpa", "graph"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--force", dest="skip_existing", action="store_false")
    args = ap.parse_args(argv)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    todo = [(a, s, m) for a, s in cells() for m in meshes]
    failures = []
    t0 = time.time()
    for i, (arch, shape, mesh) in enumerate(todo):
        fname = OUT / f"{arch}_{shape}_{mesh}.json"
        if args.skip_existing and fname.exists():
            print(f"[sweep {i+1}/{len(todo)}] skip {fname.name}", flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--mesh", mesh]
        if arch != "graph-lpa":
            cmd += ["--shape", shape]
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        t1 = time.time()
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=CELL_TIMEOUT_S)
            ok, err = proc.returncode == 0, proc.stderr
        except subprocess.TimeoutExpired as e:
            ok = False
            err = f"timed out after {CELL_TIMEOUT_S} s\n" + (
                e.stderr.decode() if isinstance(e.stderr, bytes)
                else e.stderr or "")
        print(f"[sweep {i+1}/{len(todo)}] {arch} {shape} {mesh}: "
              f"{'OK' if ok else 'FAIL'} ({time.time()-t1:.0f}s)",
              flush=True)
        if not ok:
            failures.append((arch, shape, mesh))
            print(err[-1500:], flush=True)
    print(f"[sweep] done in {time.time()-t0:.0f}s; "
          f"failures: {failures or 'none'}", flush=True)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
