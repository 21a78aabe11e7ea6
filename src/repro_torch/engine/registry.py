"""Backend strategy registry + auto-selection policy.

A backend is a stateless strategy object with four hooks:

  * ``plan_key(config)`` — extra hashable statics of its plans;
  * ``build(bucket, config, device)`` — the plan for one bucket (cached);
  * ``prepare(graph, bucket, config)`` — per-graph inputs on the device;
  * ``run(plan, inputs, n_real, init_labels, init_active)`` — execute,
    returning a :class:`BackendRun`.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.engine.bucketing import BucketKey, max_degree, next_pow2
from repro_torch.engine.config import EngineConfig, unported


class BackendRun(NamedTuple):
    """Raw backend output (labels still padded + uncompacted)."""
    labels: np.ndarray        # (bucket rows,) int32 — engine slices [:n_real]
    lpa_iterations: int
    split_iterations: int
    lpa_seconds: float
    split_seconds: float


class Backend(Protocol):
    name: str

    def plan_key(self, config: EngineConfig) -> tuple: ...

    def build(self, bucket: BucketKey, config: EngineConfig,
              device: torch.device): ...

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig): ...

    def run(self, plan, inputs, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun: ...


def device_sync(device: torch.device) -> None:
    """Wait for the device, so a host clock read after it times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_BACKENDS: dict[str, Backend] = {}


def register_backend(name: str):
    def deco(cls):
        _BACKENDS[name] = cls()
        return cls
    return deco


def get_backend(name: str) -> Backend:
    if name == "sharded":
        raise unported("sharded backend")
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


def choose_backend(graph: Graph, config: EngineConfig,
                   device: torch.device) -> str:
    """Pick a backend from graph shape and device."""
    d = next_pow2(max(max_degree(graph), 1))
    if torch.device(device).type == "cuda" and d <= _TILE_MAX_DEGREE \
            and graph.n * d <= _TILE_MAX_CELLS:
        return "tile"
    return "segment"
