"""Plan cache keyed by (backend, bucket, algorithm statics, device).

A plan holds what a backend precomputes per bucket (device-resident parity
classes, row ids, the resolved fusion choice).  ``PLAN_LOG`` counts plan
builds per backend stage (``"tile:propagate"``, ``"segment:split"``, ...):
a stream of same-bucket graphs builds each stage once, and a later fit of
the bucket is a cache hit that leaves the counts untouched.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Any, Callable, Hashable


class PlanLog:
    """Counts plan builds per backend stage."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Counter[str] = Counter()

    def record(self, tag: str) -> None:
        with self._lock:
            self.counts[tag] += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)


PLAN_LOG = PlanLog()


class PlanCache:
    """Keyed store of backend plans with hit/miss accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: dict[Hashable, Any] = {}
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Hashable,
                     make_plan: Callable[[], Any]) -> tuple[Any, bool]:
        """Returns (plan, was_hit)."""
        with self._lock:
            if key in self._plans:
                self.hits += 1
                return self._plans[key], True
            self.misses += 1
        plan = make_plan()
        with self._lock:
            self._plans.setdefault(key, plan)
            return self._plans[key], False

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses}


# Process-wide default: Engines without an explicit cache share it.
GLOBAL_CACHE = PlanCache()
