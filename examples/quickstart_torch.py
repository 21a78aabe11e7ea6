"""Quickstart: GSL-LPA community detection through the PyTorch Engine.

    PYTHONPATH=src python examples/quickstart_torch.py                # CUDA
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py`` on the PyTorch port: on the card the
tile backend runs the hand-written CUDA kernels, on the CPU their plain
versions.
"""
import argparse

import numpy as np

from repro_torch.core import gsl_lpa, gve_lpa
from repro_torch.engine import Engine, EngineConfig
from repro_torch.graphgen import karate_club, planted_partition


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the fits run (default: cuda)")
    device = ap.parse_args(argv).device
    eng = Engine(EngineConfig(backend="auto", compute_metrics=True,
                              device=device))

    # --- Zachary's karate club ---
    g, truth = karate_club()
    res = eng.fit(g)                       # propagation + Split-Last
    print(f"karate club: {res.num_communities} communities, "
          f"Q={res.modularity:.3f}, {res.lpa_iterations} LPA iters, "
          f"{res.split_iterations} split sweeps "
          f"[{res.backend} backend on {res.device}, bucket {res.bucket}]")

    # --- planted partition: GSL-LPA vs plain parallel LPA (GVE-LPA) ---
    g2, truth2 = planted_partition(12, 50, p_in=0.3, p_out=0.003, seed=7)
    no_split = Engine(EngineConfig(split="none", compute_metrics=True,
                                   device=device))
    for name, engine in (("GVE-LPA (no split)", no_split),
                         ("GSL-LPA (split-last)", eng)):
        r = engine.fit(g2)
        print(f"{name:22s} Q={r.modularity:.3f} "
              f"communities={r.num_communities} "
              f"disconnected_frac={r.disconnected_fraction:.3%}  "
              f"t={r.total_seconds * 1e3:.0f}ms")

    # same-bucket graphs share one plan: the second fit is a cache hit
    g3, _ = planted_partition(12, 50, p_in=0.3, p_out=0.003, seed=8)
    r3 = eng.fit(g3)
    print(f"second same-bucket fit: cache_hit={r3.cache_hit}, "
          f"t={r3.total_seconds * 1e3:.0f}ms")

    # several graphs in one batched dispatch, each as its solo fit
    batch = eng.fit_many([g, g2, g3])
    assert all(np.array_equal(b.labels, s.labels)
               for b, s in zip(batch, (res, eng.fit(g2), r3)))
    print(f"fit_many of 3 graphs agrees with solo fits: True "
          f"[bucket {batch[0].bucket}]")

    # the wrappers are thin facades over the Engine
    legacy = gsl_lpa(g, split="lp", device=device)
    assert np.array_equal(legacy.labels, res.labels), \
        "gsl_lpa diverged from the Engine result"
    assert gve_lpa(g2, device=device).labels.shape == (g2.n,)
    print("legacy gsl_lpa agrees: True")

    # ground-truth recovery check
    labels = res.labels
    agree = np.mean([
        (labels[i] == labels[j]) == (truth[i] == truth[j])
        for i in range(0, 34, 3) for j in range(i + 1, 34, 3)])
    print(f"karate pairwise agreement with factions: {agree:.2%}")


if __name__ == "__main__":
    main()
