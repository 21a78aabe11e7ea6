"""GSL-LPA (Algorithm 3): thin wrappers over the Engine.

``gsl_lpa`` is the paper's headline algorithm; ``gve_lpa`` is the base
parallel LPA without splitting (the paper's own ablation baseline, §A.2).

Both are facades over :class:`repro_torch.engine.Engine` on the segment
backend with ``bucketing="exact"`` and the process-wide plan cache.  Like
every entry point of the package they run on CUDA unless given
``device="cpu"``.  New code should use the Engine directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.graph import Graph

SPLIT_METHODS = ("none", "lp", "lpp", "bfs_host")


@dataclass
class GslResult:
    labels: np.ndarray          # final community membership, dense [0, K)
    lpa_iterations: int
    split_iterations: int       # 0 for none / bfs_host
    lpa_seconds: float
    split_seconds: float
    # The underlying Engine result (timings, backend, cache_hit, device).
    detail: "object | None" = None

    @property
    def total_seconds(self) -> float:
        return self.lpa_seconds + self.split_seconds


def gsl_lpa(graph: Graph, tau: float = 0.05, max_iterations: int = 20,
            split: str = "lp", shortcut: bool = False,
            init_labels=None, device=None) -> GslResult:
    """Run GSL-LPA end to end.

    split: ``"none"`` -> GVE-LPA; ``"lp"`` / ``"lpp"`` -> Algorithm 1;
    ``"bfs_host"`` -> Algorithm 2 on the host.  ``device``: ``None``
    means CUDA.
    """
    from repro_torch.engine import Engine, EngineConfig

    if split not in SPLIT_METHODS:
        raise ValueError(f"split must be one of {SPLIT_METHODS}, "
                         f"got {split!r}")
    eng = Engine(EngineConfig(backend="segment", tau=tau,
                              max_iterations=max_iterations, split=split,
                              shortcut=shortcut, bucketing="exact",
                              device=device))
    res = eng.fit(graph, init_labels=init_labels)
    return GslResult(labels=res.labels,
                     lpa_iterations=res.lpa_iterations,
                     split_iterations=res.split_iterations,
                     lpa_seconds=res.lpa_seconds,
                     split_seconds=res.split_seconds,
                     detail=res)


def gve_lpa(graph: Graph, **kw) -> GslResult:
    """The paper's base parallel LPA (no splitting): the ablation
    baseline."""
    kw.pop("split", None)
    return gsl_lpa(graph, split="none", **kw)
