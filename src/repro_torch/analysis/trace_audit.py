"""Runtime plan auditor: zero excess plan builds, mechanically checked.

The port's perf contract is *one plan per (stage, backend, bucket)*:
same-bucket traffic must reuse the plans the first fit built, across
solo, batched, warm-started, out-of-core and sharded fits.  What the JAX
package audits is jit traces; the port has no tracing, and its
counterpart is a plan build: each ``PLAN_LOG.record(tag)`` a backend's
``build*`` makes, which ``PlanCache.get_or_build`` runs only on a miss.
:class:`TraceAudit` keeps the reference's names and API and gates any
workload on it:

    with TraceAudit() as audit:
        run_workload(device="cpu")
    audit.assert_no_excess()          # or audit.report() / write_json()

Attribution: the engine and the out-of-core loop wrap each plan fetch
in :func:`repro_torch.engine.cache.plan_context`, and the cache that
builds names itself, so every record lands in a (stage, (backend,
bucket), cache) bin.  A bin with more than one build means a plan was
built again where the cache should have reused it: an unstable key, or
a build outside the cache.  A *different* bucket building is fine (that
is what buckets are for), and so is a second cache building its own
plan once (an Engine with its own ``PlanCache``).

The other compile of the port is the kernel library: one ``nvcc`` build
and one ``ctypes`` load per process (``kernels/build.py``).  The audit
reports the builds and loads in its window, and counts a process that
built or loaded the library more than once as excess.

Report keys are the reference's: a row's ``traces`` is its plan builds.
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.engine.cache import PLAN_LOG, PlanLog
from repro_torch.kernels import build as kernel_build


class ExcessRetraceError(AssertionError):
    """A (stage, backend, bucket) built its plan more than once in one
    cache under audit, or the kernel library was built or loaded more
    than once in the process."""


class TraceAudit:
    """Context manager diffing per-context plan builds around a
    workload."""

    def __init__(self, log: PlanLog | None = None):
        self.log = log if log is not None else PLAN_LOG
        self._before: dict[tuple, int] = {}
        self._after: dict[tuple, int] | None = None
        self._lib_before: dict[str, int] = {}
        self._lib_after: dict[str, int] | None = None

    def __enter__(self) -> "TraceAudit":
        self._before = self.log.context_snapshot()
        self._after = None
        self._lib_before = dict(kernel_build.LIBRARY_EVENTS)
        self._lib_after = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._after = self.log.context_snapshot()
        self._lib_after = dict(kernel_build.LIBRARY_EVENTS)

    def _snapshot_now(self) -> dict[tuple, int]:
        return self._after if self._after is not None \
            else self.log.context_snapshot()

    def deltas(self) -> dict[tuple, int]:
        """(stage tag, context, cache) -> plan builds in the window."""
        after = self._snapshot_now()
        out = {}
        for key, count in after.items():
            d = count - self._before.get(key, 0)
            if d > 0:
                out[key] = d
        return out

    def excess(self) -> dict[tuple, int]:
        """The violations: any (stage, context, cache) that built > 1."""
        return {k: v for k, v in self.deltas().items() if v > 1}

    def library_events(self) -> dict[str, int]:
        """Kernel-library builds and loads in the window, and in the
        whole process so far (``*_process``)."""
        now = self._lib_after if self._lib_after is not None \
            else dict(kernel_build.LIBRARY_EVENTS)
        out = {k: now[k] - self._lib_before.get(k, 0) for k in now}
        out.update({f"{k}_process": v for k, v in now.items()})
        return out

    def library_excess(self) -> dict[str, int]:
        ev = self.library_events()
        return {k: ev[f"{k}_process"] for k in ("builds", "loads")
                if ev[f"{k}_process"] > 1}

    def report(self) -> dict[str, Any]:
        rows = []
        for (tag, ctx, cache), count in sorted(self.deltas().items(),
                                               key=lambda kv: repr(kv[0])):
            backend, bucket = (None, None) if ctx is None else ctx
            rows.append({
                "stage": tag,
                "backend": backend,
                "bucket": list(bucket) if isinstance(bucket, tuple)
                else bucket,
                "cache": cache,
                "traces": count,
                "excess": count > 1,
            })
        n_excess = sum(1 for r in rows if r["excess"])
        lib = self.library_events()
        lib_excess = self.library_excess()
        return {
            "contexts": rows,
            "total_traces": sum(r["traces"] for r in rows),
            "excess_contexts": n_excess,
            "library": lib,
            "library_excess": lib_excess,
            "ok": n_excess == 0 and not lib_excess,
        }

    def assert_no_excess(self) -> None:
        bad = self.excess()
        lines = [f"  {tag} @ {ctx} in cache {cache}: {count} plan builds"
                 for (tag, ctx, cache), count in sorted(
                     bad.items(), key=lambda kv: repr(kv[0]))]
        lines += [f"  kernel library: {count} {what} in this process"
                  for what, count in self.library_excess().items()]
        if lines:
            raise ExcessRetraceError(
                "excess plan builds — the plan cache was bypassed for:\n"
                + "\n".join(lines))

    def write_json(self, path) -> dict[str, Any]:
        report = self.report()
        with open(path, "w") as fh:
            json.dump(report, fh, indent=2, default=str)
            fh.write("\n")
        return report
