"""Per-fit result-quality telemetry: is the answer still good?

Modularity (paper Eq. 1), the disconnected-community fraction (the
paper's headline invariant, live instead of test-only), community count
and size distribution, and label churn against the previous assignment
(the resolved warm-start labels of the fit).

Everything here runs on the host at a stage boundary, after the sweep
loops have converged and the final labels are on the host.  The only
device work is one modularity pass
(:func:`repro_torch.core.modularity.modularity`) and
``DetectionResult.check_connected``, both on the final assignment, and
the engine pays them only in "full" mode ("basic" stays host-only:
sizes, count, churn).  ``EngineConfig.quality`` is not part of
``algo_key()``, so every mode shares the "off" plans and labels and
iteration counts are the same in every mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

QUALITY_MODES = ("off", "basic", "full")

# Churn is a fraction in [0, 1]; fine buckets at the low end where the
# steady-state streaming signal lives.
CHURN_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0)


@dataclasses.dataclass
class QualityReport:
    """Quality of one detection result.  ``DetectionResult.quality``."""

    mode: str                  # "basic" | "full"
    n: int                     # vertices covered by the assignment
    num_communities: int
    # Paper Eq. 1.  The engine pays this device pass only in "full" mode;
    # None on "basic" engine reports and on host-only reports.  Direct
    # compute_quality callers get it whenever they pass a graph.
    modularity: float | None
    # Fraction of communities that are internally disconnected (0.0 after
    # any split mode).  Only in "full" mode; None in "basic" and on
    # host-only reports.
    disconnected_fraction: float | None
    size_min: int
    size_max: int
    size_mean: float
    size_p50: float
    size_p99: float
    # Fraction of vertices whose community changed against the previous
    # assignment (see :func:`label_churn`); None with no previous one.
    churn: float | None
    churn_compared: int        # vertices the churn fraction was taken over

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def canonical_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel communities by order of first occurrence.

    Two assignments that induce the same partition canonicalize to the
    same array no matter how either names its communities, so element-wise
    comparison measures membership drift rather than label renaming.
    """
    labels = np.asarray(labels)
    _, first, inverse = np.unique(labels, return_index=True,
                                  return_inverse=True)
    # np.unique ranks communities by label value; re-rank by first
    # occurrence so community naming cannot manufacture churn.
    order = np.argsort(np.argsort(first))
    return order[inverse.reshape(labels.shape)].astype(np.int64)


def label_churn(prev: Any, new: Any) -> tuple[float | None, int]:
    """``(churned_fraction, compared)`` between two assignments.

    Both sides are canonicalized (:func:`canonical_labels`) and compared
    element-wise over the common vertex prefix, so identical partitions
    report exactly 0.0 regardless of labeling.  For differing partitions
    this is an upper bound on membership change: a moved vertex always
    counts, and a move that re-ranks community first-occurrence order can
    drag bystanders with it.  Returns ``(None, 0)`` with no previous
    assignment.
    """
    if prev is None:
        return None, 0
    prev = np.asarray(prev)
    new = np.asarray(new)
    k = min(prev.shape[0], new.shape[0])
    if k == 0:
        return None, 0
    a = canonical_labels(prev[:k])
    b = canonical_labels(new[:k])
    return float(np.mean(a != b)), int(k)


def compute_quality(labels: Any, *, mode: str, graph: Any = None,
                    prev_labels: Any = None,
                    num_communities: int | None = None,
                    modularity: float | None = None,
                    disconnected_fraction: float | None = None,
                    ) -> QualityReport:
    """Build a :class:`QualityReport` for a final label assignment.

    ``graph=None`` produces a host-only report (sizes, count, churn).
    With a graph, modularity is one pass on the graph's device.
    ``modularity`` / ``disconnected_fraction`` accept already-computed
    values (``compute_metrics``, ``check_connected``'s cache) so quality
    never repeats a device pass another layer paid for.
    """
    if mode not in QUALITY_MODES or mode == "off":
        raise ValueError(f"quality mode must be 'basic' or 'full', "
                         f"got {mode!r}")
    labels = np.asarray(labels)
    n = int(labels.shape[0])
    sizes = np.bincount(labels.astype(np.int64, copy=False)) if n else \
        np.zeros(0, dtype=np.int64)
    sizes = sizes[sizes > 0]
    k = int(num_communities if num_communities is not None else sizes.shape[0])
    if modularity is None and graph is not None:
        import torch

        from repro_torch.core.modularity import modularity as _modularity
        modularity = float(_modularity(
            graph, torch.from_numpy(np.ascontiguousarray(labels))))
    churn, compared = label_churn(prev_labels, labels)
    return QualityReport(
        mode=mode, n=n, num_communities=k,
        modularity=modularity,
        disconnected_fraction=(disconnected_fraction
                               if mode == "full" else None),
        size_min=int(sizes.min()) if sizes.size else 0,
        size_max=int(sizes.max()) if sizes.size else 0,
        size_mean=float(sizes.mean()) if sizes.size else 0.0,
        size_p50=float(np.percentile(sizes, 50)) if sizes.size else 0.0,
        size_p99=float(np.percentile(sizes, 99)) if sizes.size else 0.0,
        churn=churn, churn_compared=compared)


def record_report(scope: Any, report: QualityReport) -> None:
    """Write a report through a registry scope (``<scope>.reports``,
    ``.communities``, ...; callers pass an already-namespaced scope).

    Gauges carry the latest fit's level (modularity, community count,
    disconnected fraction); the churn histogram accumulates the drift
    distribution across fits.
    """
    if scope is None or report is None:
        return
    scope.counter("reports").inc()
    scope.gauge("communities").set(report.num_communities)
    scope.gauge("size_max").set(report.size_max)
    if report.modularity is not None:
        scope.gauge("modularity").set(report.modularity)
    if report.disconnected_fraction is not None:
        scope.gauge("disconnected_fraction").set(report.disconnected_fraction)
    if report.churn is not None:
        scope.histogram("churn", CHURN_BUCKETS).observe(report.churn)
