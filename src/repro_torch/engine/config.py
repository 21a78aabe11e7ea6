"""Engine configuration and the unified detection result.

``EngineConfig`` is the knob surface of :class:`repro_torch.engine.Engine`;
``DetectionResult`` is the backend-independent return type of ``fit`` and
of each member of ``fit_many``.
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
WARM_START = ("off", "auto")
PROFILE = ("off", "convergence", "full")
QUALITY = ("off", "basic", "full")

# Option -> the ROADMAP item (Queue A) that ports it.
UNPORTED = {
    "sharded backend": "A12 (multi-device)",
    "mesh": "A12 (multi-device)",
    "exchange_every": "A12 (multi-device)",
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
    warm_start: ``"auto"`` keeps a bounded LRU (``warm_cache_size``
      entries) of ``graph_fingerprint -> last labels``, updated on every
      fit and every ``fit_many`` member, so a re-fit of a structurally
      identical graph starts warm.  ``"off"``: warm only from caller
      labels.
    patch_churn_threshold: ``launch.stream`` splices a delta into the CSR
      (``apply_delta_patch``) when it touches fewer than this share of the
      vertices, and rebuilds it (``apply_delta``) otherwise.  The same
      bytes either way.
    profile: per-fit convergence profile depth (``repro_torch.obs``).
      ``"convergence"`` records the propagation phase's per-sub-sweep
      frontier / changed counts, ``"full"`` the Split-Last phase too.  The
      loops write them into a buffer on the device that comes down once
      with the labels, so labels and iteration counts equal ``"off"``'s
      and no host read enters a sweep loop.  Part of ``algo_key()``:
      ``"off"`` keeps its own plans.  Results: ``DetectionResult.profile``.
    quality: per-fit result-quality report (``repro_torch.obs.quality``)
      on the final labels, after convergence.  ``"basic"`` is host-only:
      community count, size summary, churn against the warm-start labels;
      ``"full"`` adds the disconnected fraction (``check_connected``,
      cached by fingerprint) and one modularity pass.  Not part of
      ``algo_key()``: every mode shares the ``"off"`` plans.  Results:
      ``DetectionResult.quality`` and the engine scope's ``quality.*``
      metrics.
    memory_budget: resident edge-byte cap of a fit (bytes, or ``"64MB"`` /
      ``"1GiB"``; ``None``: no cap).  A graph whose edge arrays
      (13 B per directed edge slot) exceed it is fitted out of core,
      partition by partition (``repro_torch.partition``), with labels
      equal to the in-core fit's.  ``Engine.fit(..., memory_budget=)``
      overrides it per call.
    exchange_every, mesh: accepted only at their defaults (see
      ``UNPORTED``).
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
    warm_cache_size: int = 64
    patch_churn_threshold: float = 0.20
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
            from repro_torch.partition.plan import parse_bytes
            budget = parse_bytes(self.memory_budget)
            if budget < 1:
                raise ValueError("memory_budget must be >= 1 byte")
            object.__setattr__(self, "memory_budget", budget)
        for name, value, allowed in (
                ("backend", self.backend, BACKENDS),
                ("split", self.split, SPLIT_METHODS),
                ("bucketing", self.bucketing, BUCKETING),
                ("fuse_sweeps", self.fuse_sweeps, FUSE_SWEEPS),
                ("kernel_mode", self.kernel_mode, KERNEL_MODES),
                ("warm_start", self.warm_start, WARM_START),
                ("profile", self.profile, PROFILE),
                ("quality", self.quality, QUALITY)):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {value!r}")
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be >= 0")
        if self.warm_cache_size < 1:
            raise ValueError("warm_cache_size must be >= 1")
        if not 0.0 <= self.patch_churn_threshold <= 1.0:
            raise ValueError("patch_churn_threshold must be in [0, 1]")

    def algo_key(self) -> tuple:
        """The hashable algorithm statics a plan specialises on."""
        return (self.tau, self.max_iterations, self.split, self.shortcut,
                self.kernel_mode, self.fuse_sweeps, self.profile)


@dataclasses.dataclass
class DetectionResult:
    """Unified result of ``Engine.fit`` and of each member of
    ``Engine.fit_many`` — identical shape for all backends."""
    labels: np.ndarray            # (n,) int32, compacted to dense [0, K)
    num_communities: int
    backend: str                  # backend that actually ran
    lpa_iterations: int
    split_iterations: int         # 0 for split in ("none", "bfs_host")
    timings: dict[str, float]     # phase -> seconds
    bucket: tuple                 # (n, m, d), or (k, n, m, d) when batched
    cache_hit: bool               # plan came from the engine's plan cache
    warm_started: bool            # fit started from caller or cached labels
    device: str = "cpu"           # where the fit ran
    modularity: float | None = None
    disconnected_fraction: float | None = None
    # Batched dispatch (``Engine.fit_many``): how many graphs shared the
    # dispatch and this graph's place in the pack.  Batch-level stage
    # times appear as ``"prorated_*"`` keys: work-share estimates, not
    # measurements.
    batch_size: int = 1
    batch_index: int = 0
    # Out-of-core fits: the partition count (1 = in core) and the loop's
    # counters (``OocRun.stats()``: peak resident bytes, halo exchange
    # bytes, partition loads, prefetch and cache hits).
    partitions: int = 1
    ooc: dict | None = None
    # ``EngineConfig.profile != "off"``: a
    # :class:`repro_torch.obs.ConvergenceProfile`; ``quality != "off"``: a
    # :class:`repro_torch.obs.QualityReport`.  None otherwise.
    profile: Any = dataclasses.field(default=None, compare=False)
    quality: Any = dataclasses.field(default=None, compare=False)
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
    def lpa_seconds(self) -> float:
        """Propagation seconds: measured on a solo fit, a work-share
        estimate on a batched member."""
        return (self.timings.get("propagation", 0.0)
                + self.timings.get("prorated_propagation", 0.0))

    @property
    def split_seconds(self) -> float:
        return (self.timings.get("split", 0.0)
                + self.timings.get("prorated_split", 0.0))

    @property
    def total_seconds(self) -> float:
        return sum(self.timings.values())
