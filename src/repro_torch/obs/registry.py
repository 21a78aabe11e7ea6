"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of the JAX package's ``obs/registry.py``: the same
metric names, the same ``snapshot()`` shape.  Components claim a *scope*
(a child view whose metric names are prefixed and stored in the shared
root), write through plain ``Counter`` / ``Gauge`` / ``Histogram``
handles, and keep their ``stats()`` methods as reads of their own state.

* **Thread-safe.**  The micro-batcher's worker, client threads and
  ``stats()`` pollers write at once.  One root lock guards the name
  table; each metric carries its own lock.
* **Multi-instance.**  ``scope()`` hands the bare prefix to the first
  claimant and ``prefix#N`` to later ones, so per-instance reads never
  alias; ``Scope.release()`` frees the label and drops its metrics.
* **No device work.**  Everything here is host bookkeeping, written at
  stage boundaries, never inside a sweep loop.
"""
from __future__ import annotations

import bisect
import re
import threading
from collections import deque
from typing import Any, Callable, Iterable

_RESERVOIR = 4096  # raw samples kept per histogram for exact small-N quantiles


class Counter:
    """Monotonic event count."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time level (queue depth, resident bytes, cache entries)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, n) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket distribution with a bounded raw-sample reservoir.

    Buckets are cumulative upper bounds (Prometheus-style ``le``); the
    reservoir keeps the most recent ``_RESERVOIR`` observations so small
    runs get *exact* quantiles — the thin-view ``stats()`` methods that
    used to hold their own latency lists read them from here instead.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count", "_samples",
                 "_exemplars")

    def __init__(self, buckets: Iterable[float]):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = overflow
        self._sum = 0.0
        self._count = 0
        self._samples: deque[float] = deque(maxlen=_RESERVOIR)
        # Last (value, span_id) observed per bucket (incl. overflow) —
        # OpenMetrics exemplars linking a latency bucket to the trace
        # span that produced it.  Only kept when observe() ran inside a
        # tracer span.
        self._exemplars: list[tuple[float, int] | None] = \
            [None] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.buckets, v)
        # Exemplar capture: one contextvar read; the tracer never calls
        # back into the registry, so no lock-order hazard.
        from repro_torch.obs.trace import TRACER
        cur = TRACER.current()
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            self._samples.append(v)
            if cur is not None:
                self._exemplars[idx] = (v, cur.span_id)

    def exemplars(self) -> list[tuple[float, int] | None]:
        """Per-bucket ``(value, span_id)`` exemplars (overflow last)."""
        with self._lock:
            return list(self._exemplars)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Exact over the reservoir (the full stream while it fits)."""
        with self._lock:
            if not self._samples:
                return 0.0
            xs = sorted(self._samples)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def summary(self) -> dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            xs = sorted(self._samples)

        def _q(q: float) -> float:
            return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else 0.0
        return {"count": total, "sum": s,
                "mean": (s / total if total else 0.0),
                "p50": _q(0.50), "p95": _q(0.95), "p99": _q(0.99),
                "buckets": {f"le_{b:g}": c
                            for b, c in zip(self.buckets, counts)}
                | {"overflow": counts[-1]}}


class Scope:
    """Child view of a registry: names are prefixed into the shared root."""

    def __init__(self, root: "MetricsRegistry", label: str):
        self._root = root
        self.label = label
        self._released = False

    def counter(self, name: str) -> Counter:
        return self._root._get(f"{self.label}.{name}", Counter)

    def gauge(self, name: str) -> Gauge:
        return self._root._get(f"{self.label}.{name}", Gauge)

    def histogram(self, name: str, buckets: Iterable[float]) -> Histogram:
        return self._root._get(f"{self.label}.{name}", Histogram, buckets)

    def scope(self, prefix: str) -> "Scope":
        return self._root.scope(f"{self.label}.{prefix}")

    def release(self) -> None:
        """Free this scope's label and drop its metrics from the root."""
        if not self._released:
            self._released = True
            self._root._release(self.label)


class MetricsRegistry:
    """Thread-safe named-metric store with scoped child views."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}
        self._labels: set[str] = set()

    def _get(self, name: str, kind: Callable, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(*args)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Iterable[float]) -> Histogram:
        return self._get(name, Histogram, buckets)

    def scope(self, prefix: str) -> Scope:
        """Claim a child namespace.  The first claimant of ``prefix``
        gets the bare label; later ones get ``prefix#1``, ``prefix#2``…
        so per-instance metrics never alias across instances."""
        with self._lock:
            label, i = prefix, 0
            while label in self._labels:
                i += 1
                label = f"{prefix}#{i}"
            self._labels.add(label)
        return Scope(self, label)

    def _release(self, label: str) -> None:
        # Child labels ("serve.admission" under "serve") go too — else the
        # next instance gets the bare parent label but "#1"-suffixed
        # children, and absolute child-metric names silently alias.
        with self._lock:
            self._labels = {l for l in self._labels
                            if l != label and not l.startswith(label + ".")}
            dead = [k for k in self._metrics
                    if k == label or k.startswith(label + ".")]
            for k in dead:
                del self._metrics[k]

    def metrics(self) -> dict[str, Any]:
        """Shallow copy of ``name -> metric instance`` (exporters read the
        live handles for bucket counts and exemplars the summary drops)."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict[str, Any]:
        """Flat ``name -> value`` dict; histograms expand to summaries."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict[str, Any] = {}
        for name, m in items:
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def render_text(self) -> str:
        """Human-readable one-metric-per-line dump (for CLIs / logs)."""
        lines = []
        for name, v in self.snapshot().items():
            if isinstance(v, dict):  # histogram summary
                lines.append(
                    f"{name}  count={v['count']} mean={v['mean']:.4g} "
                    f"p50={v['p50']:.4g} p95={v['p95']:.4g} "
                    f"p99={v['p99']:.4g}")
            elif isinstance(v, float):
                lines.append(f"{name}  {v:.6g}")
            else:
                lines.append(f"{name}  {v}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._labels.clear()


class CappedCounterSet:
    """Bounded per-key counter family over an unbounded id space.

    The first ``max_labels`` distinct keys each get their own counter
    (``<scope>.<name>.<key>``); every later key shares one
    ``<scope>.<name>.other`` overflow counter.  This is how per-tenant
    counts enter the registry without per-tenant cardinality: tenant ids
    are caller-chosen strings, and a registry must never absorb an
    unbounded label space (the Prometheus exporter renders every name).
    Exact per-key numbers stay available from the owning component's
    ``stats()`` dict.
    """

    def __init__(self, scope: "Scope", name: str, max_labels: int = 16):
        if max_labels < 1:
            raise ValueError("max_labels must be >= 1")
        self._scope = scope
        self._name = name
        self._max = max_labels
        self._lock = threading.Lock()
        self._handles: dict[str, Counter] = {}
        self._other: Counter | None = None

    def counter(self, key: Any) -> Counter:
        k = str(key)
        with self._lock:
            h = self._handles.get(k)
            if h is None:
                if len(self._handles) < self._max:
                    # Keys are metric-name segments: no dots (fake
                    # hierarchy) or whitespace.
                    safe = re.sub(r"[^A-Za-z0-9_\-]", "_", k)
                    h = self._scope.counter(f"{self._name}.{safe}")
                    self._handles[k] = h
                else:
                    if self._other is None:
                        self._other = self._scope.counter(
                            f"{self._name}.other")
                    h = self._other
            return h

    def inc(self, key: Any, n: int = 1) -> None:
        self.counter(key).inc(n)

    @property
    def tracked(self) -> tuple[str, ...]:
        """Keys that own a dedicated counter (≤ ``max_labels``)."""
        with self._lock:
            return tuple(self._handles)


# The process-global root every component defaults to.  Tests that need
# isolation construct their own MetricsRegistry and inject it.
REGISTRY = MetricsRegistry()
