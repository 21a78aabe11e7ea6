"""Per-tenant quality/SLO health: ring-buffer timelines + drift alerts.

The serving tier completes thousands of fits across tenants; this module
keeps a bounded per-tenant timeline of :class:`QualitySample` records
(latency + the fit's :class:`repro_torch.obs.QualityReport` fields) and raises
:class:`Alert` records when a tenant drifts:

* ``modularity_drop`` — modularity fell more than
  ``HealthConfig.modularity_drop`` below the tenant's previous sample
  (the answers are getting worse faster than streaming drift explains);
* ``disconnected`` — the disconnected-community fraction went nonzero
  (the paper's headline invariant broke — this should never fire);
* ``slo_burn`` — the tenant's rolling p99 latency exceeded
  ``HealthConfig.slo_p99_ms`` (edge-triggered: one alert per excursion,
  re-armed when p99 recovers).

Aggregate counts go through the metrics registry (alert counters, last
modularity / disconnected-fraction gauges); per-tenant detail stays on
``stats()`` — tenant ids are an unbounded label space the registry must
never absorb (see ``CappedCounterSet`` for the bounded exception).
Everything is host-side bookkeeping under one lock; nothing here touches
the device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Drift/SLO thresholds for :class:`HealthMonitor`."""

    timeline_len: int = 128        # samples kept per tenant (ring buffer)
    modularity_drop: float = 0.05  # alert when modularity falls > this
    slo_p99_ms: float | None = None  # latency SLO; None disables slo_burn
    latency_window: int = 32       # samples in the rolling p99
    max_alerts: int = 256          # alert records kept (ring buffer)

    def __post_init__(self):
        if self.timeline_len < 1:
            raise ValueError("timeline_len must be >= 1")
        if self.modularity_drop <= 0:
            raise ValueError("modularity_drop must be > 0")
        if self.slo_p99_ms is not None and self.slo_p99_ms <= 0:
            raise ValueError("slo_p99_ms must be > 0")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")


@dataclasses.dataclass
class QualitySample:
    """One completed fit on a tenant's timeline."""

    ts: float
    kind: str                      # request kind: register | update | ...
    latency_ms: float
    modularity: float | None = None
    disconnected_fraction: float | None = None
    communities: int | None = None
    churn: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Alert:
    """One drift/SLO violation record."""

    ts: float
    tenant: Any
    kind: str                      # modularity_drop | disconnected | slo_burn
    value: float
    threshold: float
    message: str

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tenant"] = str(self.tenant)
        return d


class TenantTimeline:
    """Bounded sample history for one tenant (not thread-safe on its own
    — :class:`HealthMonitor` serializes access under its lock)."""

    def __init__(self, maxlen: int):
        self.samples: deque[QualitySample] = deque(maxlen=maxlen)
        self.total = 0  # samples ever recorded (ring drops old ones)

    def append(self, sample: QualitySample) -> None:
        self.samples.append(sample)
        self.total += 1

    @property
    def last(self) -> QualitySample | None:
        return self.samples[-1] if self.samples else None

    def p99_latency(self, window: int) -> float:
        xs = sorted(s.latency_ms for s in
                    list(self.samples)[-window:])
        if not xs:
            return 0.0
        return xs[min(int(0.99 * len(xs)), len(xs) - 1)]

    def to_dict(self) -> dict[str, Any]:
        last = self.last
        return {"samples": self.total,
                "window": len(self.samples),
                "last": last.to_dict() if last else None}


class HealthMonitor:
    """Aggregates per-tenant timelines and emits drift/SLO alerts."""

    def __init__(self, config: HealthConfig | None = None, scope=None):
        self.config = config if config is not None else HealthConfig()
        self._lock = threading.Lock()
        self._timelines: dict[Any, TenantTimeline] = {}
        self.alerts: deque[Alert] = deque(maxlen=self.config.max_alerts)
        self._alert_counts: dict[str, int] = {}
        self._burning: set[Any] = set()   # tenants in an slo_burn excursion
        self._scope = scope
        if scope is not None:
            self._m_samples = scope.counter("samples")
            self._m_alerts = {
                kind: scope.counter(f"alerts_{kind}")
                for kind in ("modularity_drop", "disconnected", "slo_burn")}
            self._g_modularity = scope.gauge("modularity")
            self._g_disconnected = scope.gauge("disconnected_fraction")
            self._g_tenants = scope.gauge("tenants")
        else:
            self._m_samples = None

    def record(self, tenant: Any, sample: QualitySample) -> list[Alert]:
        """Append a sample; return (and retain) any alerts it triggered."""
        cfg = self.config
        fired: list[Alert] = []
        with self._lock:
            tl = self._timelines.get(tenant)
            if tl is None:
                tl = self._timelines[tenant] = TenantTimeline(
                    cfg.timeline_len)
            prev = tl.last
            tl.append(sample)

            if (sample.modularity is not None and prev is not None
                    and prev.modularity is not None):
                drop = prev.modularity - sample.modularity
                if drop > cfg.modularity_drop:
                    fired.append(Alert(
                        ts=sample.ts, tenant=tenant, kind="modularity_drop",
                        value=drop, threshold=cfg.modularity_drop,
                        message=(f"tenant {tenant}: modularity fell "
                                 f"{drop:.4f} (> {cfg.modularity_drop:g}) "
                                 f"to {sample.modularity:.4f}")))
            if sample.disconnected_fraction:
                fired.append(Alert(
                    ts=sample.ts, tenant=tenant, kind="disconnected",
                    value=float(sample.disconnected_fraction), threshold=0.0,
                    message=(f"tenant {tenant}: disconnected-community "
                             f"fraction {sample.disconnected_fraction:.4f} "
                             f"> 0 — paper invariant violated")))
            if cfg.slo_p99_ms is not None:
                p99 = tl.p99_latency(cfg.latency_window)
                if p99 > cfg.slo_p99_ms:
                    if tenant not in self._burning:  # edge-triggered
                        self._burning.add(tenant)
                        fired.append(Alert(
                            ts=sample.ts, tenant=tenant, kind="slo_burn",
                            value=p99, threshold=cfg.slo_p99_ms,
                            message=(f"tenant {tenant}: p99 latency "
                                     f"{p99:.2f}ms burns the "
                                     f"{cfg.slo_p99_ms:g}ms SLO")))
                else:
                    self._burning.discard(tenant)

            for a in fired:
                self.alerts.append(a)
                self._alert_counts[a.kind] = \
                    self._alert_counts.get(a.kind, 0) + 1
            n_tenants = len(self._timelines)

        if self._m_samples is not None:
            self._m_samples.inc()
            self._g_tenants.set(n_tenants)
            if sample.modularity is not None:
                self._g_modularity.set(sample.modularity)
            if sample.disconnected_fraction is not None:
                self._g_disconnected.set(
                    float(sample.disconnected_fraction))
            for a in fired:
                self._m_alerts[a.kind].inc()
        return fired

    def timeline(self, tenant: Any) -> TenantTimeline | None:
        with self._lock:
            return self._timelines.get(tenant)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "tenants": {str(t): tl.to_dict()
                            for t, tl in self._timelines.items()},
                "alert_counts": dict(self._alert_counts),
                "alerts": [a.to_dict() for a in list(self.alerts)[-16:]],
                "burning": sorted(str(t) for t in self._burning),
            }


def sample_from_result(result: Any, *, kind: str,
                       latency_ms: float) -> QualitySample:
    """Build a sample from a ``DetectionResult`` (quality optional)."""
    q = getattr(result, "quality", None)
    return QualitySample(
        ts=time.time(), kind=kind, latency_ms=float(latency_ms),
        modularity=getattr(q, "modularity", None),
        disconnected_fraction=getattr(q, "disconnected_fraction", None),
        communities=getattr(q, "num_communities", None),
        churn=getattr(q, "churn", None))
