"""Mixed cold/warm/delta load generation for the multi-tenant tier.

Used by ``python -m repro_torch.launch.serve --mode tenants`` and the
``serve`` phase of ``chip_smoke.py``: builds per-tenant evolving-graph
traces, drives them from concurrent client threads through a
:class:`~repro_torch.serve.service.TenantService`, retries on
:class:`~repro_torch.serve.admission.Rejected` backpressure (honouring the
``retry_after_s`` hint), samples queue depth, and reports the SLO
surface — sustained aggregate edges/s, latency percentiles, queue depth,
rejection rate — plus the hard liveness invariant: **every admitted
request resolves** (zero stranded futures, zero drops without an
explicit rejection).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.serve.admission import Rejected


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Shape of the generated traffic.

    tenants: number of concurrent tenants (each one evolving graph).
    rounds: delta updates per tenant after the cold register.
    size / avg_degree / delta_edges: per-tenant ``evolving_sequence``
      trace parameters.
    refresh_every: every k-th round, tenants outside ``parity_tenants``
      issue a cold ``refresh`` instead of a delta update (the mixed
      cold/warm traffic leg).  0 disables refreshes.
    parity_tenants: the first k tenants never refresh, so their warm
      chains can be replayed solo and compared bit-for-bit.
    client_threads: concurrent client threads driving disjoint tenant
      subsets.
    max_retries: attempts per request under backpressure before the
      client gives up (counted, never silent).
    """
    tenants: int = 32
    rounds: int = 4
    size: int = 120
    avg_degree: float = 5.0
    delta_edges: int = 4
    refresh_every: int = 3
    parity_tenants: int = 4
    client_threads: int = 8
    max_retries: int = 200
    seed: int = 0


def tenant_trace(cfg: LoadConfig, i: int) -> tuple[str, tuple]:
    """Tenant ``i``'s name and (base graph, [deltas]) evolving trace."""
    from repro_torch.graphgen import evolving_sequence
    return f"tenant-{i:03d}", evolving_sequence(
        cfg.size, cfg.avg_degree, cfg.rounds, cfg.delta_edges,
        seed=cfg.seed + 17 * i)


def build_traces(cfg: LoadConfig) -> dict:
    """Per-tenant (base graph, [deltas]) evolving traces."""
    return dict(tenant_trace(cfg, i) for i in range(cfg.tenants))


def _submit_with_retry(fn, record, max_retries: int):
    """Call ``fn()`` (an admission attempt), sleeping out Rejected
    backpressure.  Returns the ticket; records retry count."""
    for attempt in range(max_retries):
        try:
            ticket = fn()
            record["retries"] += attempt
            return ticket
        except Rejected as rej:
            time.sleep(rej.retry_after_s)
    raise RuntimeError(f"request not admitted after {max_retries} retries")


def run_load(service, traces: dict, cfg: LoadConfig) -> tuple[list, dict]:
    """Drive the traces through ``service`` from concurrent clients.

    Every tenant: one cold register, then ``rounds`` requests — deltas
    (warm) except every ``refresh_every``-th round for non-parity
    tenants, which goes cold via ``refresh``.  Returns ``(records,
    summary)``: one record per resolved request, and the SLO summary.
    """
    tenant_ids = list(traces)
    parity = set(tenant_ids[: cfg.parity_tenants])
    counters = {"retries": 0, "give_ups": 0, "errors": 0}
    counters_lock = threading.Lock()
    records: list[dict] = []
    records_lock = threading.Lock()
    depth_samples: list[int] = []
    stop_sampling = threading.Event()

    def sample_depth() -> None:
        while not stop_sampling.is_set():
            depth_samples.append(service.admission.stats()["depth"])
            time.sleep(0.002)

    def wait_all(tickets: list) -> None:
        for tid, kind, ticket in tickets:
            exc = ticket.exception()
            rec = {"tenant": tid, "kind": kind,
                   "latency_s": ticket.latency_s,
                   "ok": exc is None}
            if exc is None:
                res = ticket.result()
                rec.update(edges=_edges_of(service, tid),
                           warm_started=bool(res.warm_started),
                           lpa_iterations=int(res.lpa_iterations))
            with records_lock:
                records.append(rec)
            if exc is not None:
                with counters_lock:
                    counters["errors"] += 1

    def client(my_tenants: list) -> None:
        local = {"retries": 0}
        try:
            tickets = []
            for tid in my_tenants:
                base, _deltas = traces[tid]
                tickets.append((tid, "register", _submit_with_retry(
                    lambda tid=tid, base=base: service.register(tid, base),
                    local, cfg.max_retries)))
            wait_all(tickets)   # registers settle before deltas apply
            for r in range(cfg.rounds):
                tickets = []
                for tid in my_tenants:
                    _base, deltas = traces[tid]
                    cold = (cfg.refresh_every
                            and tid not in parity
                            and r % cfg.refresh_every == cfg.refresh_every - 1)
                    if cold:
                        tickets.append((tid, "refresh", _submit_with_retry(
                            lambda tid=tid: service.refresh(tid),
                            local, cfg.max_retries)))
                    else:
                        tickets.append((tid, "update", _submit_with_retry(
                            lambda tid=tid, d=deltas[r]:
                            service.update(tid, d),
                            local, cfg.max_retries)))
                wait_all(tickets)
        except RuntimeError:
            with counters_lock:
                counters["give_ups"] += 1
        finally:
            with counters_lock:
                counters["retries"] += local["retries"]

    # disjoint tenant subsets per client thread
    chunks: list[list] = [[] for _ in range(cfg.client_threads)]
    for i, tid in enumerate(tenant_ids):
        chunks[i % cfg.client_threads].append(tid)

    sampler = threading.Thread(target=sample_depth, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(chunk,), daemon=True)
               for chunk in chunks if chunk]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    stop_sampling.set()
    sampler.join()

    stats = service.stats()
    lat = np.asarray([r["latency_s"] for r in records
                      if r["latency_s"] is not None]) * 1e3
    total_edges = sum(r.get("edges", 0) for r in records if r["ok"])
    adm = stats["admission"]
    # liveness: every admitted request resolved, one way or the other —
    # no stranded futures, no drops without an explicit rejection
    resolved = stats["completed"] + stats["failed"]
    summary = {
        "tenants": cfg.tenants,
        "rounds": cfg.rounds,
        "requests": len(records),
        "completed": stats["completed"],
        "failed": stats["failed"],
        "admitted": adm["accepted"],
        "resolved": resolved,
        "stranded": adm["accepted"] - resolved,
        "outstanding": stats["outstanding"],
        "rejections": adm["rejected"],
        "rejection_rate": adm["rejected"]
        / max(adm["rejected"] + adm["accepted"], 1),
        "retries": counters["retries"],
        "give_ups": counters["give_ups"],
        "errors": counters["errors"],
        "queue_depth_peak": adm["peak_depth"],
        "queue_depth_mean": float(np.mean(depth_samples))
        if depth_samples else 0.0,
        "warm_bytes_peak": stats["warm_bytes"]["peak"],
        "warm_budget": stats["warm_bytes"]["budget"],
        "spills": stats["spills"],
        "wall_s": wall_s,
        "edges_per_s": total_edges / max(wall_s, 1e-9),
        "p50_ms": float(np.percentile(lat, 50)) if len(lat) else 0.0,
        "p99_ms": float(np.percentile(lat, 99)) if len(lat) else 0.0,
        "mean_batch": stats["batcher"]["mean_batch"],
    }
    return records, summary


def _edges_of(service, tenant) -> int:
    try:
        return int(service.graph(tenant).num_edges)
    except KeyError:
        return 0


def replay_parity(traces: dict, parity_records: dict, engine_config) -> dict:
    """Solo-oracle replay for the parity tenants.

    Re-runs each parity tenant's exact op sequence (cold register, then
    warm delta updates with frontier seeding) through a fresh solo
    engine — no batching, no admission, no sharing — and returns the
    final labels per tenant.  The harness asserts these bit-identical to
    the service's committed labels: multiplexing over one engine changes
    latency, never results.
    """
    from repro_torch.core.delta import affected_frontier, apply_delta
    from repro_torch.engine import Engine, PlanCache
    out = {}
    for tid in parity_records:
        eng = Engine(engine_config, cache=PlanCache())
        base, deltas = traces[tid]
        labels = eng.fit(base).labels
        graph = base
        for d in deltas:
            graph = apply_delta(graph, d)
            init = labels
            if graph.n > len(init):
                init = np.concatenate([
                    init, np.arange(len(init), graph.n, dtype=np.int32)])
            front = affected_frontier(d, graph.n)
            labels = eng.fit(graph, init_labels=init,
                             init_active=front).labels
        out[tid] = labels
    return out
