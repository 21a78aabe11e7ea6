"""Plan cache keyed by (backend, bucket, algorithm statics, device).

A plan holds what a backend precomputes per bucket (device-resident parity
classes, row ids, the resolved fusion choice).  ``PLAN_LOG`` counts plan
builds per backend stage (``"tile:propagate"``, ``"segment:split"``, ...):
a stream of same-bucket graphs builds each stage once, and a later fit of
the bucket is a cache hit that leaves the counts untouched.

Attribution for the plan auditor (``repro_torch.analysis.trace_audit``):
the engine and the out-of-core loop set the current (backend, bucket)
with :func:`plan_context` around each plan fetch, and ``get_or_build``
names the cache that builds; so every ``PLAN_LOG.record`` of a backend's
``build*`` lands in a (stage, (backend, bucket), cache) bin.  The JAX
package attributes jit traces the same way (its ``trace_context``).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
from collections import Counter
from typing import Any, Callable, Hashable

# ContextVars keep nested or threaded engines from clobbering each other.
_PLAN_CONTEXT: contextvars.ContextVar[tuple | None] = \
    contextvars.ContextVar("repro_torch_plan_context", default=None)
_BUILDING_CACHE: contextvars.ContextVar[int | None] = \
    contextvars.ContextVar("repro_torch_building_cache", default=None)
_CACHE_SERIAL = itertools.count(1)


def current_plan_context() -> tuple | None:
    return _PLAN_CONTEXT.get()


@contextlib.contextmanager
def plan_context(backend: str, bucket):
    """Attribute any plan builds in the body to ``(backend, bucket)``."""
    token = _PLAN_CONTEXT.set((backend, tuple(bucket)
                               if isinstance(bucket, (list, tuple))
                               else bucket))
    try:
        yield
    finally:
        _PLAN_CONTEXT.reset(token)


class PlanLog:
    """Counts plan builds per backend stage, and per attributed bin."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Counter[str] = Counter()
        # (tag, plan context, cache serial) -> count; context None for
        # unattributed builds, cache None for builds outside a cache
        self.context_counts: Counter[tuple] = Counter()

    def record(self, tag: str) -> None:
        key = (tag, _PLAN_CONTEXT.get(), _BUILDING_CACHE.get())
        with self._lock:
            self.counts[tag] += 1
            self.context_counts[key] += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def context_snapshot(self) -> dict[tuple, int]:
        with self._lock:
            return dict(self.context_counts)


PLAN_LOG = PlanLog()


class PlanCache:
    """Keyed store of backend plans with hit/miss accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: dict[Hashable, Any] = {}
        self.hits = 0
        self.misses = 0
        self.serial = next(_CACHE_SERIAL)   # names the cache in PLAN_LOG

    def get_or_build(self, key: Hashable,
                     make_plan: Callable[[], Any]) -> tuple[Any, bool]:
        """Returns (plan, was_hit)."""
        with self._lock:
            if key in self._plans:
                self.hits += 1
                return self._plans[key], True
            self.misses += 1
        token = _BUILDING_CACHE.set(self.serial)
        try:
            plan = make_plan()
        finally:
            _BUILDING_CACHE.reset(token)
        with self._lock:
            self._plans.setdefault(key, plan)
            return self._plans[key], False

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses}


# Process-wide default: Engines without an explicit cache share it.
GLOBAL_CACHE = PlanCache()
