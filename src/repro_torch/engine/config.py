"""Engine configuration and the unified detection result.

``EngineConfig`` is the knob surface of :class:`repro_torch.engine.Engine`;
``DetectionResult`` is the backend-independent return type of ``fit``.
Options of the JAX engine that this package does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that ports them; none is
silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

BACKENDS = ("auto", "segment", "tile")
SPLIT_METHODS = ("none", "lp", "lpp", "bfs_host")
BUCKETING = ("pow2", "exact")
FUSE_SWEEPS = ("auto", "on", "off")
KERNEL_MODES = ("auto",)

# Option -> the ROADMAP item (Queue A) that ports it.
UNPORTED = {
    "sharded backend": "A12 (multi-device)",
    "mesh": "A12 (multi-device)",
    "exchange_every": "A12 (multi-device)",
    "memory_budget": "A9 (out-of-core)",
    "warm_start='auto'": "A7 (warm starts and streaming)",
    "profile": "A10 (observability and quality)",
    "quality": "A10 (observability and quality)",
    "fit_many": "A6 (batched detection)",
    "graph file paths": "A8 (ingestion)",
}


def unported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to the PyTorch engine yet "
        f"(ROADMAP Queue A, {UNPORTED[option]})")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration for :class:`repro_torch.engine.Engine`.

    backend: ``"segment"`` (edge-list sort + segment reductions, plain
      tensor ops), ``"tile"`` (padded-neighbor tiles over the four LPA
      kernels) or ``"auto"`` (tile on CUDA for degree-bounded graphs whose
      tiles fit the cell limit, else segment).
    tau / max_iterations / split / shortcut: the GSL-LPA algorithm knobs
      (paper Algorithm 3 + Section 4), the JAX engine's semantics.
    bucketing: ``"pow2"`` pads vertex / edge / degree counts to powers of
      two so same-bucket graphs share one plan; ``"exact"`` plans per exact
      shape (and uses the Python-float threshold ``int(tau * n)`` on the
      segment backend).
    compute_metrics: also report modularity and the disconnected-community
      fraction on the result.
    kernel_mode: ``"auto"`` only — a CUDA tensor runs the CUDA kernel, a
      CPU tensor its plain version.
    fuse_sweeps: tile backend — one fused kernel per sub-sweep (wake +
      move, wake + min-label) instead of a kernel plus tensor glue.
      ``"auto"`` fuses exactly when the kernels run, i.e. on CUDA.  Labels
      and iteration counts are identical either way.
    device: where the fit runs; ``None`` means ``"cuda"``.  The CPU runs
      only when asked for (``device="cpu"``).
    warm_start, memory_budget, exchange_every, mesh, profile, quality:
      accepted only at their defaults (see ``UNPORTED``).
    """
    backend: str = "auto"
    tau: float = 0.05
    max_iterations: int = 20
    split: str = "lp"
    shortcut: bool = False
    bucketing: str = "pow2"
    min_vertex_bucket: int = 256
    min_edge_bucket: int = 2048
    compute_metrics: bool = False
    kernel_mode: str = "auto"
    fuse_sweeps: str = "auto"
    device: str | None = None
    warm_start: str = "off"
    memory_budget: int | str | None = None
    exchange_every: int = 1
    mesh: Any = None
    profile: str = "off"
    quality: str = "off"

    def __post_init__(self):
        if self.backend == "sharded":
            raise unported("sharded backend")
        if self.mesh is not None:
            raise unported("mesh")
        if self.exchange_every != 1:
            raise unported("exchange_every")
        if self.memory_budget is not None:
            raise unported("memory_budget")
        if self.warm_start == "auto":
            raise unported("warm_start='auto'")
        if self.profile != "off":
            raise unported("profile")
        if self.quality != "off":
            raise unported("quality")
        for name, value, allowed in (
                ("backend", self.backend, BACKENDS),
                ("split", self.split, SPLIT_METHODS),
                ("bucketing", self.bucketing, BUCKETING),
                ("fuse_sweeps", self.fuse_sweeps, FUSE_SWEEPS),
                ("kernel_mode", self.kernel_mode, KERNEL_MODES),
                ("warm_start", self.warm_start, ("off",))):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {value!r}")
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be >= 0")

    def algo_key(self) -> tuple:
        """The hashable algorithm statics a plan specialises on."""
        return (self.tau, self.max_iterations, self.split, self.shortcut,
                self.kernel_mode, self.fuse_sweeps)


@dataclasses.dataclass
class DetectionResult:
    """Unified result of ``Engine.fit`` — identical shape for all backends."""
    labels: np.ndarray            # (n,) int32, compacted to dense [0, K)
    num_communities: int
    backend: str                  # backend that actually ran
    lpa_iterations: int
    split_iterations: int         # 0 for split in ("none", "bfs_host")
    timings: dict[str, float]     # phase -> seconds
    bucket: tuple                 # (n, m, d)
    cache_hit: bool               # plan came from the engine's plan cache
    warm_started: bool            # fit started from caller labels
    device: str = "cpu"           # where the fit ran
    modularity: float | None = None
    disconnected_fraction: float | None = None
    _connected_fp: Any = dataclasses.field(
        default=None, repr=False, compare=False)

    def check_connected(self, graph) -> float:
        """Disconnected-community fraction, computed lazily and cached.

        ``graph`` must be the graph this result was fitted on; the cache
        keys on its structural fingerprint, so a different graph
        recomputes.  Runs on the graph's device.
        """
        import torch

        from repro_torch.core.detect import disconnected_fraction
        from repro_torch.core.graph import graph_fingerprint
        fp = graph_fingerprint(graph)
        if self.disconnected_fraction is None or self._connected_fp != fp:
            labels = torch.from_numpy(self.labels).to(graph.device)
            self.disconnected_fraction = float(
                disconnected_fraction(graph, labels))
            self._connected_fp = fp
        return self.disconnected_fraction

    @property
    def total_seconds(self) -> float:
        return sum(self.timings.values())
