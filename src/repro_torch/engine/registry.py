"""Backend strategy registry + auto-selection policy.

A backend is a stateless strategy object with four hooks:

  * ``plan_key(config)`` — extra hashable statics of its plans;
  * ``build(bucket, config, device)`` — the plan for one bucket (cached);
  * ``prepare(graph, bucket, config)`` — per-graph inputs on the device;
  * ``run(plan, inputs, n_real, init_labels, init_active)`` — execute,
    returning a :class:`BackendRun`.

Backends that set ``supports_batch = True`` also implement the batched
trio ``build_batch`` / ``prepare_batch`` / ``run_batch``: a whole
:class:`repro_torch.core.batch.GraphBatch` in one dispatch, returning a
:class:`BatchBackendRun` with per-slot iteration counts.  ``run_batch``
takes optional packed (total_vertices,) warm labels and active seeds in
local coordinates (``GraphBatch.pack_labels``) and treats them as
per-member solo warm runs would.

Backends that set ``supports_partition = True`` also carry the partition
hooks of the out-of-core loop (:mod:`repro_torch.partition.ooc`):
``build_partition``, ``partition_caps``, ``partition_prepare_nbytes``,
``prepare_partition`` and the per-visit sweeps ``partition_move`` /
``partition_wake`` / ``partition_split`` / ``partition_split_wake`` and
their fused twins ``partition_move_fused`` / ``partition_split_fused``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.graph import Graph
from repro_torch.engine.bucketing import (
    BatchBucketKey,
    BucketKey,
    batch_index_arrays,
    max_degree,
    next_pow2,
)
from repro_torch.engine.config import EngineConfig


class BackendRun(NamedTuple):
    """Raw backend output (labels uncompacted)."""
    labels: np.ndarray        # (n_real,) int32
    lpa_iterations: int
    split_iterations: int
    lpa_seconds: float
    split_seconds: float
    profile: Any = None       # ConvergenceProfile when profiling


class BatchBackendRun(NamedTuple):
    """Raw batched-backend output (local labels, per-slot iterations)."""
    labels: np.ndarray            # (total_vertices,) int32 local labels
    lpa_iterations: np.ndarray    # (k_bucket + 1,) int32 per slot
    split_iterations: np.ndarray  # (k_bucket + 1,) int32 per slot
    lpa_seconds: float
    split_seconds: float
    profile: Any = None           # one ConvergenceProfile per slot


class BatchIndex(NamedTuple):
    """A batch's per-slot and per-row index arrays for the batched loops
    (see ``bucketing.batch_index_arrays``)."""
    sizes: np.ndarray        # (k_bucket + 1,) int32, host
    graph_id: torch.Tensor   # (rows,) int32 owner slot, on the device
    voffset: torch.Tensor    # (rows,) int32 owner offset, on the device
    voffset_host: np.ndarray  # the same offsets on the host
    n_total: int             # packed vertex count


class Backend(Protocol):
    name: str
    supports_batch: bool

    def plan_key(self, config: EngineConfig) -> tuple: ...

    def build(self, bucket: BucketKey, config: EngineConfig,
              device: torch.device): ...

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig): ...

    def run(self, plan, inputs, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun: ...

    def build_batch(self, bucket: BatchBucketKey, config: EngineConfig,
                    device: torch.device): ...

    def prepare_batch(self, batch, bucket: BatchBucketKey,
                      config: EngineConfig): ...

    def run_batch(self, plan, inputs,
                  init_labels: np.ndarray | None = None,
                  init_active: np.ndarray | None = None,
                  ) -> BatchBackendRun: ...


def device_sync(device: torch.device) -> None:
    """Wait for the device, so a host clock read after it times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: to CUDA through pinned
    memory (one host copy, then an upload on the current stream)."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def pad_to_device(col: np.ndarray, length: int,
                  device: torch.device) -> torch.Tensor:
    """A host vector zero-padded to ``length``, as a tensor on ``device``
    (an out-of-core partition's owned-row state padded to its rows)."""
    out = np.zeros(length, dtype=col.dtype)
    out[: len(col)] = col
    return to_device(out, device)


def batch_index(batch, k_bucket: int, rows: int,
                device: torch.device) -> BatchIndex:
    sizes, graph_id, voffset = batch_index_arrays(batch, k_bucket, rows)
    return BatchIndex(sizes=sizes, graph_id=to_device(graph_id, device),
                      voffset=to_device(voffset, device),
                      voffset_host=voffset, n_total=batch.total_vertices)


def to_host(values: torch.Tensor, n: int,
            *buffers: torch.Tensor | None) -> tuple:
    """The first ``n`` entries of a 1-D tensor, and each of ``buffers``
    whole (profile buffers; None passes through), as numpy arrays: from
    CUDA each is copied into pinned memory, then one synchronize."""
    out = []
    for t in (values[:n], *buffers):
        if t is not None and t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        out.append(t)
    if values.device.type == "cuda":
        torch.cuda.current_stream(values.device).synchronize()
    return tuple(None if t is None else t.numpy() for t in out)


def profile_plan(config: EngineConfig, do_split: bool) -> dict:
    """A plan's profile statics: ``profile`` (propagation records) and
    ``split_rows``, the split buffer's rows (0: the split records
    nothing; ``profile="full"`` with a split gives ``2 * max_iterations``,
    and a longer split overwrites the last row)."""
    full = config.profile == "full" and do_split
    return {"profile": config.profile != "off",
            "split_rows": 2 * config.max_iterations if full else 0}


_BACKENDS: dict[str, Backend] = {}


def register_backend(name: str):
    def deco(cls):
        _BACKENDS[name] = cls()
        return cls
    return deco


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {backend_names()}") from None


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


# Auto-selection: the tile path materialises (rows, d) dense neighbor
# tiles — a win for degree-bounded graphs, a memory loss on skewed ones.
# The limits are the JAX engine's.
_TILE_MAX_DEGREE = 1024
_TILE_MAX_CELLS = 1 << 24


def _multi_rank(config: EngineConfig) -> bool:
    """A mesh was given, or this process is one of several ranks: the
    JAX engine's ``device_count() > 1 or mesh is not None``."""
    return config.mesh is not None or (
        dist.is_available() and dist.is_initialized()
        and dist.get_world_size() > 1)


def choose_backend(graph: Graph, config: EngineConfig,
                   device: torch.device) -> str:
    """Pick a backend from graph shape, device and ranks."""
    if _multi_rank(config):
        return "sharded"
    return _choose(graph.n, max_degree(graph), device)


def choose_backend_batch(graphs, config: EngineConfig,
                         device: torch.device) -> str:
    """Pick a backend for a batched dispatch: ``choose_backend``'s policy
    applied to the packed totals (all rows, the widest member's degree)."""
    if _multi_rank(config):
        return "sharded"
    return _choose(sum(g.n for g in graphs),
                   max(max_degree(g) for g in graphs), device)


def _choose(n: int, degree: int, device: torch.device) -> str:
    d = next_pow2(max(degree, 1))
    if torch.device(device).type == "cuda" and d <= _TILE_MAX_DEGREE \
            and n * d <= _TILE_MAX_CELLS:
        return "tile"
    return "segment"
