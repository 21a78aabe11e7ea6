"""Runtime observability of the port: metrics registry, span tracer,
per-fit convergence profiles and quality reports.

* :class:`MetricsRegistry` / :data:`REGISTRY` — process-global named
  counters / gauges / histograms with scoped child views (the engine's
  ``engine`` scope, the micro-batcher's ``batcher`` scope).
* :class:`Tracer` / :data:`TRACER` / :func:`span` — contextvar-nested
  wall-time spans over host-side stage boundaries, exported as a
  Chrome-trace (``chrome://tracing`` / Perfetto) JSON array.
* :class:`ConvergenceProfile` — per-sub-sweep frontier / changed curves
  written on the device inside the sweep loops and fetched once with the
  labels, surfaced as ``DetectionResult.profile`` behind
  ``EngineConfig.profile``.
* :class:`QualityReport` / :func:`compute_quality` — per-fit result
  quality (modularity, disconnected fraction, community sizes, label
  churn) behind ``EngineConfig.quality``; host-side, after convergence.
* :func:`prometheus_text` / :class:`MetricsServer` / :class:`JsonlSink`
  — exporters: Prometheus text format (with span-id exemplars on
  histograms), a stdlib HTTP scrape endpoint, and a JSONL file sink.

``python -m repro_torch.launch.obs`` runs a profiled fit, dumps the
registry and exports the spans.  The same names and shapes as the JAX
package's ``repro.obs``; nothing here imports it.
"""
from repro_torch.obs.convergence import (
    ConvergenceProfile,
    PhaseProfile,
    empty_batch_profile_buffer,
    empty_profile_buffer,
    phase_from_batch_buffer,
    phase_from_buffer,
    phase_from_rows,
)
from repro_torch.obs.export import (
    JsonlSink,
    MetricsServer,
    parse_prometheus_text,
    prometheus_text,
)
from repro_torch.obs.quality import (
    QualityReport,
    canonical_labels,
    compute_quality,
    label_churn,
    record_report,
)
from repro_torch.obs.registry import (
    REGISTRY,
    CappedCounterSet,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Scope,
)
from repro_torch.obs.trace import TRACER, Span, Tracer, span

__all__ = [
    "REGISTRY", "MetricsRegistry", "Scope", "Counter", "Gauge", "Histogram",
    "CappedCounterSet",
    "TRACER", "Tracer", "Span", "span",
    "ConvergenceProfile", "PhaseProfile",
    "empty_profile_buffer", "empty_batch_profile_buffer",
    "phase_from_buffer", "phase_from_batch_buffer", "phase_from_rows",
    "QualityReport", "compute_quality", "label_churn", "canonical_labels",
    "record_report",
    "prometheus_text", "parse_prometheus_text", "MetricsServer", "JsonlSink",
]
