"""R006 — telemetry discipline in hot-path sweep code.

The observability layer (``repro_torch.obs``) is host-side bookkeeping
by contract: spans and registry writes wrap *stage boundaries* (engine
prepare/dispatch/compact, ooc phases, serving admission→settle), never
the per-sweep inner loops, and convergence profiles record on the device
into preallocated buffers precisely so no telemetry runs per sweep.
This rule enforces that contract inside the hot modules (``core/``,
``kernels/``, ``engine/backends/``):

* **compiled scopes** (functions handed to ``torch.compile`` /
  ``torch.jit``, as R001 finds them): any host timer
  (``time.perf_counter`` & friends), tracer span (``obs.trace.span``),
  metrics-registry call or quality hook — under compilation a graph
  break, or a host call burnt into every call;
* **sweep-dispatch loops**: the same calls inside a ``for``/``while``
  body that dispatches sweep work (R001's sweep callables: a kernel
  entry point ``ops.label_argmax(...)``, a core sweep, a partition hook,
  ``plan.step(...)``) — a timer or counter per sweep reintroduces exactly
  the per-iteration host overhead the fused dispatch work removed.
  Stage-boundary timing *around* such loops stays legal.

The device-side profile write ``obs.convergence.record_row`` (as the tile
loops call it per sub-sweep) is not telemetry: it copies count tensors
into a preallocated buffer on the same device, with no host read — the
port's counterpart of the JAX package's ``buf.at[row].set(...)``.  For
the same reason ``.set`` (a ``Gauge`` write, but also an in-place update
idiom) is not in the metric-write list.

Deliberate exceptions carry ``# lint: telemetry-ok — <why>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import ModuleContext, Rule, dotted_name
from repro_torch.analysis.rules.r001_host_sync import (
    all_functions,
    is_sweep_call,
    step_callables,
    traced_functions,
)

_HOT_PREFIXES = ("core/", "kernels/", "engine/backends/")

# Host wall-clock reads (bare names cover `from time import perf_counter`).
_TIMER_CALLS = {"time.perf_counter", "perf_counter", "time.monotonic",
                "monotonic", "time.perf_counter_ns", "time.time"}
# Span tracer entry points (repro_torch.obs.trace).
_SPAN_CALLS = {"span", "obs.span", "trace.span", "TRACER.span",
               "tracer.span"}
# Metric-handle mutators (repro_torch.obs.registry Counter / Histogram).
_METRIC_METHODS = {"inc", "observe"}
# Registry roots: REGISTRY.counter(...), scope.histogram(...), etc.
_REGISTRY_ROOTS = {"REGISTRY", "registry"}
_REGISTRY_METHODS = {"counter", "gauge", "histogram", "scope"}
# Quality hooks (repro_torch.obs.quality + DetectionResult.check_connected):
# host-side reductions over the *final* labels by contract — inside a
# sweep loop they pay a full modularity / connectivity pass per sweep.
_QUALITY_CALLS = {"compute_quality", "record_report", "label_churn",
                  "check_connected"}


def _telemetry_call(node: ast.Call) -> str | None:
    """Short description when ``node`` is a telemetry call, else None."""
    name = dotted_name(node.func)
    if name in _TIMER_CALLS:
        return f"host timer {name}()"
    if name in _SPAN_CALLS:
        return f"tracer span {name}()"
    if name in _QUALITY_CALLS:
        return f"quality hook {name}()"
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _QUALITY_CALLS:
            return f"quality hook .{attr}()"
        if attr in _METRIC_METHODS:
            return f"metric write .{attr}()"
        root = dotted_name(node.func.value)
        if root in _REGISTRY_ROOTS and attr in _REGISTRY_METHODS:
            return f"registry call {root}.{attr}()"
    return None


class TelemetryRule(Rule):
    id = "R006"
    tag = "telemetry"
    description = ("telemetry (perf_counter / spans / metric writes) inside "
                   "compiled or per-sweep hot-path code")

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(_HOT_PREFIXES)

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        traced = traced_functions(ctx.tree)
        for fn in all_functions(ctx.tree):
            if fn in traced:
                findings.extend(self._check_traced(ctx, fn))
            else:
                findings.extend(self._check_sweep_loops(ctx, fn))
        return findings

    def _check_traced(self, ctx: ModuleContext,
                      fn: ast.FunctionDef) -> list[Finding]:
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            what = _telemetry_call(node)
            if what:
                out.append(self.finding(
                    ctx, node,
                    f"{what} inside compiled '{fn.name}' — telemetry "
                    f"must stay host-side at stage boundaries (use the "
                    f"device-side profile buffer for per-sweep counts)"))
        return out

    def _check_sweep_loops(self, ctx: ModuleContext,
                           fn: ast.FunctionDef) -> list[Finding]:
        steps = step_callables(fn)
        out = []
        for loop in (n for n in ast.walk(fn)
                     if isinstance(n, (ast.For, ast.While))):
            if not any(is_sweep_call(c, steps) for c in ast.walk(loop)
                       if isinstance(c, ast.Call)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                what = _telemetry_call(node)
                if what:
                    out.append(self.finding(
                        ctx, node,
                        f"{what} inside a sweep-dispatch loop in "
                        f"'{fn.name}' — per-sweep telemetry reintroduces "
                        f"per-iteration host overhead; time the loop as "
                        f"one stage instead"))
        # nested loops walk the same nodes twice: one finding per site
        seen: set[tuple[int, int]] = set()
        uniq = []
        for f in out:
            if (f.line, f.col) not in seen:
                seen.add((f.line, f.col))
                uniq.append(f)
        return uniq
