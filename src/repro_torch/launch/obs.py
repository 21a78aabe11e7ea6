"""Observability CLI: run a profiled fit, dump the metrics registry,
export spans as a Chrome trace, print convergence profiles, or watch a
live metrics endpoint top-style.

    python -m repro_torch.launch.obs                  # fit on the card + dump
    python -m repro_torch.launch.obs --device cpu     # the same on the CPU
    python -m repro_torch.launch.obs --profile convergence   # propagation only
    python -m repro_torch.launch.obs --graph web.mtx  # profile a real graph
    python -m repro_torch.launch.obs --trace trace.json   # chrome://tracing
    python -m repro_torch.launch.obs --json obs.json  # machine-readable
    python -m repro_torch.launch.obs --workload audit --device cpu
    python -m repro_torch.launch.obs --workload top \\
        --endpoint http://127.0.0.1:9100              # live snapshot loop

The fit runs on CUDA unless ``--device cpu`` is given.  The trace JSON
loads into ``chrome://tracing`` or Perfetto; the registry dump is the
``snapshot()`` of :data:`repro_torch.obs.REGISTRY`.  The ``top`` workload
polls a :class:`repro_torch.obs.MetricsServer`'s ``/metrics.json`` (or
the in-process registry) and renders the busiest metrics sorted by
activity — histograms by observation count, counters/gauges by value.
``--workload audit`` runs the JAX package's every-dispatch-family sweep
(``repro_torch.analysis.audit_workload``) on ``--device`` and prints its
coverage.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.obs import REGISTRY, TRACER


def _print_profile(profile) -> None:
    for phase in (profile.propagation, profile.split):
        if phase is None:
            continue
        print(f"[obs] {phase.phase} curve ({phase.num_sub_sweeps} sub-sweeps "
              f"over n={profile.n}):")
        print(f"  {'sweep':>5} {'active':>8} {'changed':>8} {'decay':>7}")
        for s, a, c in zip(phase.sweep, phase.active, phase.changed):
            decay = a / profile.n if profile.n else 0.0
            print(f"  {int(s):>5} {int(a):>8} {int(c):>8} {decay:>7.3f}")


def _fit_workload(a) -> dict:
    from repro_torch.engine import Engine, EngineConfig, PlanCache

    if a.graph:
        from repro_torch.io import load_graph
        graph = load_graph(a.graph)
    else:
        from repro_torch.graphgen import erdos_renyi
        graph = erdos_renyi(a.n, a.degree, seed=a.seed)
    eng = Engine(EngineConfig(backend=a.backend, split=a.split,
                              profile=a.profile, device=a.device),
                 cache=PlanCache())
    r = eng.fit(graph)
    print(f"[obs] fit n={graph.n} m={graph.num_edges} backend={r.backend} "
          f"split={a.split} device={r.device}: {r.num_communities} "
          f"communities in {r.lpa_iterations} lpa + {r.split_iterations} "
          f"split iterations")
    if r.profile is not None:
        _print_profile(r.profile)
    return {"profile": r.profile.to_dict() if r.profile else None}


def _audit_workload(a) -> dict:
    """The audit workload (``analysis.audit_workload``) on ``--device``:
    the JAX package's coverage line and dict."""
    from repro_torch.analysis import audit_workload
    coverage = audit_workload(device=a.device).coverage
    print("[obs] audit workload coverage: "
          + " ".join(f"{k}={v}" for k, v in sorted(coverage.items())))
    return {"coverage": coverage}


def _activity(value) -> float:
    """Sort key for top mode: histograms by count, scalars by magnitude."""
    if isinstance(value, dict):
        return float(value.get("count", 0))
    try:
        return abs(float(value))
    except (TypeError, ValueError):
        return 0.0


def render_top(snapshot: dict, limit: int = 20) -> str:
    """One top-style frame over a registry snapshot dict."""
    rows = sorted(snapshot.items(), key=lambda kv: (-_activity(kv[1]), kv[0]))
    lines = [f"{'metric':<48} {'value/count':>12} {'mean':>10} {'p99':>10}"]
    for name, v in rows[:limit]:
        if isinstance(v, dict):  # histogram summary
            lines.append(f"{name:<48} {v['count']:>12} "
                         f"{v['mean']:>10.4g} {v['p99']:>10.4g}")
        else:
            sv = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"{name:<48} {sv:>12} {'-':>10} {'-':>10}")
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more metrics")
    return "\n".join(lines)


def run_top(endpoint: str | None = None, every_s: float = 2.0,
            iterations: int = 0, limit: int = 20, registry=None,
            out=print) -> int:
    """Live snapshot loop (``--workload top``).

    ``endpoint`` polls a :class:`repro_torch.obs.MetricsServer`'s
    ``/metrics.json`` route; without one the in-process registry is
    rendered (what a test or an embedded run wants).  ``iterations=0``
    loops until interrupted.  Returns the number of frames rendered.
    """
    frames = 0
    while True:
        if endpoint is not None:
            import urllib.request
            with urllib.request.urlopen(
                    endpoint.rstrip("/") + "/metrics.json",
                    timeout=10) as resp:
                snapshot = json.loads(resp.read().decode())
        else:
            snapshot = (registry if registry is not None
                        else REGISTRY).snapshot()
        frames += 1
        src = endpoint or "in-process registry"
        out(f"[obs top] frame {frames} ({src}, {len(snapshot)} metrics)")
        out(render_top(snapshot, limit))
        if iterations and frames >= iterations:
            return frames
        try:
            time.sleep(every_s)
        except KeyboardInterrupt:
            return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.obs",
        description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("fit", "audit", "top"),
                    default="fit",
                    help="fit: one profiled detection; audit: the plan-audit "
                         "workload (its coverage); top: live metric snapshots "
                         "from --endpoint (or the in-process registry)")
    ap.add_argument("--graph", default=None, metavar="PATH",
                    help="fit workload: real graph file (.mtx / SNAP edge "
                         "list) instead of a synthetic one")
    ap.add_argument("--n", type=int, default=600,
                    help="fit workload: synthetic graph size")
    ap.add_argument("--degree", type=float, default=6.0,
                    help="fit workload: synthetic average degree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default=None,
                    help="fit and audit workloads: torch device (default: cuda; "
                         "'cpu' runs the plain kernel versions)")
    ap.add_argument("--split", default="lp",
                    choices=("none", "lp", "lpp", "bfs_host"))
    ap.add_argument("--profile", default="full",
                    choices=("off", "convergence", "full"),
                    help="fit workload: convergence-profile mode")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write spans as Chrome-trace JSON")
    ap.add_argument("--json", dest="json_out", default=None, metavar="PATH",
                    help="write registry snapshot (+ profile) as JSON")
    ap.add_argument("--endpoint", default=None, metavar="URL",
                    help="top workload: a MetricsServer's base URL "
                         "(polls /metrics.json); default: the in-process "
                         "registry")
    ap.add_argument("--every-s", type=float, default=2.0,
                    help="top workload: refresh interval")
    ap.add_argument("--iterations", type=int, default=0,
                    help="top workload: frames to render (0 = until ^C)")
    ap.add_argument("--limit", type=int, default=20,
                    help="top workload: rows per frame")
    a = ap.parse_args(argv)

    if a.workload == "top":
        run_top(endpoint=a.endpoint, every_s=a.every_s,
                iterations=a.iterations, limit=a.limit)
        return 0

    extra = _audit_workload(a) if a.workload == "audit" else _fit_workload(a)

    text = REGISTRY.render_text()
    print("[obs] metrics registry:")
    print(text if text.strip() else "  (empty)")
    spans = TRACER.spans()
    print(f"[obs] {len(spans)} spans recorded "
          f"({len({s.name for s in spans})} distinct names)")
    if a.trace:
        n = TRACER.export_chrome(a.trace)
        print(f"[obs] wrote {n} trace events -> {a.trace}")
    if a.json_out:
        payload = {"metrics": REGISTRY.snapshot(),
                   "num_spans": len(spans), **extra}
        with open(a.json_out, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"[obs] wrote {a.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
