"""Serving drivers of the port.

Four workloads share this entry point (``--mode``):

  * ``serve_communities`` (``communities``): a stream of graph requests
    of mixed sizes through one :class:`repro_torch.engine.Engine` behind
    a :class:`repro_torch.launch.microbatch.MicroBatcher`; up to
    ``--max-batch`` requests ride one ``fit_many`` dispatch.  Reports
    per-request latency (p50/p95), the batch-size histogram and
    aggregate edges/s.
  * ``serve_streaming`` (``streaming``): evolving-graph delta traces,
    warm batched re-detection against a cold re-detection per update.
  * ``serve_tenants`` (``tenants``): K tenants through the multi-tenant
    tier (:mod:`repro_torch.serve`).
  * ``serve`` (``lm``): LM serving of one of ``configs.ARCHS``: prefill a
    batch of prompts, then decode greedily, every attention call in the
    flash-attention kernel on the card (every family: the VLM's vision
    prefix and the encoder-decoder's frames are made as the reference
    makes them).

Every engine runs on CUDA unless ``device`` (``--device``) says
otherwise; ``--device cpu`` runs the kernels' plain versions.

    python -m repro_torch.launch.serve --mode tenants --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time

import numpy as np


def serve(arch: str, reduced: bool = True, batch: int = 4,
          prompt_len: int = 16, max_new: int = 16, s_max: int = 128,
          seed: int = 0, params=None, greedy: bool = True, device=None,
          layers: int | None = None):
    """LM serving of ``arch``: prefill ``batch`` random prompts of
    ``prompt_len`` tokens (``np.random.default_rng(seed)``, as the
    reference draws them), then ``max_new - 1`` greedy decode steps over a
    cache of ``s_max`` rows (which must hold a VLM's ``frontend_len``
    prefix too).  A VLM's prefix is zeros (B, frontend_len, d) in bf16; an
    encoder-decoder's frames are normal (B, 32, d) draws of the same
    generator, after the prompts, in bf16.  ``layers`` cuts the config's
    depth (a model whose every layer would not fit one card).  ``params``
    (else ``init_from_specs`` from ``seed``) lie on ``device`` (``None``:
    CUDA).

    Returns the reference's ``{"generated": (batch, max_new) int32 numpy,
    "prefill_s", "decode_s"}``.  The tokens stay on the device until one
    copy at the end; both times end in a ``torch.cuda.synchronize()`` on
    the card.  ``greedy`` is the reference's flag: decoding is greedy
    either way.
    """
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_from_specs

    dev = torch.device("cuda" if device is None else device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if params is None:
        params = init_from_specs(T.model_specs(cfg), seed, device=dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len)
                           ).astype(np.int32)
    inputs = {"tokens": torch.from_numpy(prompts).to(dev)}
    if cfg.family == "vlm":
        inputs["vision_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.kind == "encdec":
        # drawn after the prompts, from the same generator
        inputs["frames"] = torch.from_numpy(rng.normal(
            size=(batch, 32, cfg.d_model))).to(dev, torch.bfloat16)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = torch.empty((batch, max_new), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches = T.prefill(cfg, params, inputs, s_max)
        out[:, 0] = logits.argmax(-1)
        sync()
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(1, max_new):
            logits, caches = T.decode_step(cfg, params, caches,
                                           {"tokens": out[:, i - 1:i]})
            out[:, i] = logits[:, -1].argmax(-1)
        sync()
        t_decode = time.perf_counter() - t0
    gen = out.cpu().numpy()

    tput = batch * max_new / max(t_decode, 1e-9)
    print(f"[serve] {arch}: batch={batch} prefill {t_prefill:.2f}s, "
          f"{max_new} tokens in {t_decode:.2f}s ({tput:.1f} tok/s)",
          flush=True)
    return {"generated": gen, "prefill_s": t_prefill, "decode_s": t_decode}


def serve_communities(num_requests: int = 24, backend: str = "auto",
                      size_classes=(150, 400, 900), avg_degree: float = 6.0,
                      seed: int = 0, max_batch: int = 8,
                      batch_timeout_ms: float = 2.0,
                      graph_path: str | None = None, device=None):
    """Drive a community-detection request stream through the scheduler.

    Requests (random graphs drawn from a few size classes — a traffic
    mix) are **pre-generated outside the timed region**, submitted as a
    burst to a :class:`repro_torch.launch.microbatch.MicroBatcher`, and drained
    in batches of up to ``max_batch`` with a ``batch_timeout_ms`` linger;
    each batch is one ``Engine.fit_many`` device dispatch.  Returns
    per-request records + a summary dict (printed) with per-request
    latency percentiles, the batch-size histogram, and aggregate edges/s.
    (Fresh-graph traffic, so every request is cold; evolving-graph
    traffic goes through ``--mode streaming``, where requests carry
    warm-start labels + delta frontiers through the same batcher.)
    """
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.graphgen import erdos_renyi
    from repro_torch.launch.microbatch import MicroBatcher

    eng = Engine(EngineConfig(backend=backend, device=device))
    rng = np.random.default_rng(seed)
    # generation stays outside the timed region: request timers measure
    # serving latency, not graphgen (nor file ingest — a real graph is
    # loaded once through the parse-once CSR store up front)
    if graph_path is not None:
        from repro_torch.io import load_graph
        real, rep = load_graph(graph_path, return_report=True)
        print(f"[serve-communities] serving {graph_path}: n={real.n} "
              f"m={real.num_edges} "
              f"({'CSR cache hit' if rep.cache_hit else 'ingested'})",
              flush=True)
        graphs = [real] * num_requests
        # Batching k copies of one real graph would pack k disjoint-union
        # replicas of its CSR into a single device dispatch — k times the
        # memory of a solo fit, on exactly the files big enough to care —
        # while measuring nothing a mixed stream would.  Dispatch solo;
        # repeat fits still exercise the plan + warm caches.
        max_batch = 1
    else:
        graphs = [erdos_renyi(int(rng.choice(size_classes)), avg_degree,
                              seed=int(rng.integers(1 << 30)))
                  for _ in range(num_requests)]

    batcher = MicroBatcher(eng, max_batch=max_batch,
                           batch_timeout_ms=batch_timeout_ms,
                           autostart=False)
    t0 = time.perf_counter()
    subs = [batcher.submit(g) for g in graphs]   # burst arrival
    batcher.start()
    results = [s.result() for s in subs]
    batcher.close()
    wall_s = time.perf_counter() - t0

    records = [{"n": g.n, "edges": g.num_edges, "bucket": r.bucket,
                "backend": r.backend, "cache_hit": r.cache_hit,
                "batch_size": s.batch_size, "latency_s": s.latency_s,
                "communities": r.num_communities}
               for g, s, r in zip(graphs, subs, results)]

    total_edges = sum(g.num_edges for g in graphs)
    hits = sum(r["cache_hit"] for r in records)
    summary = {
        **batcher.stats(),
        "buckets": len({r["bucket"] for r in records}),
        "hit_rate": hits / max(len(records), 1),
        "wall_s": wall_s,
        "edges_per_s": total_edges / max(wall_s, 1e-9),
    }
    hist = ", ".join(f"{k}x{v}" for k, v in summary["batch_size_hist"].items())
    print(f"[serve-communities] {summary['requests']} requests in "
          f"{summary['batches']} batches (sizes {hist}) over "
          f"{summary['buckets']} shape buckets: hit rate "
          f"{summary['hit_rate']:.0%}, latency p50 {summary['p50_ms']:.0f}ms "
          f"p95 {summary['p95_ms']:.0f}ms, {summary['edges_per_s']:.0f} "
          f"edges/s aggregate", flush=True)
    return records, summary


def serve_streaming(num_streams: int = 6, rounds: int = 5, size: int = 150,
                    avg_degree: float = 5.0, delta_edges: int = 4,
                    backend: str = "auto", max_batch: int = 16,
                    batch_timeout_ms: float = 2.0, seed: int = 0,
                    device=None):
    """Replay evolving-graph delta traces: warm batched vs cold re-detect.

    ``num_streams`` evolving graphs (``evolving_sequence`` traces —
    small per-round edge churn) are replayed two ways, each processing
    the *same delta stream end to end* (delta application + re-detection
    both inside the timed region — a serving system has to rebuild the
    updated graph either way):

      * **cold**: every round applies each stream's delta and re-detects
        the post-delta graph from singletons, one solo ``fit`` per graph
        — the full re-detection baseline;
      * **warm**: a :class:`repro_torch.launch.stream.StreamSession` applies
        the same deltas and drives each round through the
        :class:`MicroBatcher` as one batched dispatch, each member
        warm-started from its stream's previous labels with the delta's
        affected frontier seeded unprocessed.

    Both replays get a warm-up detection per stream first so plan
    set-up cost cancels.  Prints the
    full-vs-warm speedup and returns (records, summary): one record per
    stream with its final state.
    """
    from repro_torch.core.delta import apply_delta
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.graphgen import evolving_sequence
    from repro_torch.launch.stream import StreamSession

    traces = {f"s{i}": evolving_sequence(size, avg_degree, rounds,
                                         delta_edges, seed=seed + i)
              for i in range(num_streams)}

    # cold baseline: apply delta + solo full re-detection, per stream/round
    cold_eng = Engine(EngineConfig(backend=backend, device=device))
    for sid, (base, _) in traces.items():  # warm-up: build the solo plans
        cold_eng.fit(base)
    cold_graphs = {sid: base for sid, (base, _) in traces.items()}
    t0 = time.perf_counter()
    for r in range(rounds):
        for sid, (_, deltas) in traces.items():
            cold_graphs[sid] = apply_delta(cold_graphs[sid], deltas[r])
            cold_eng.fit(cold_graphs[sid])
    cold_s = time.perf_counter() - t0

    # warm streaming session: same deltas, batched + warm labels +
    # frontier seeds (update_many re-applies them internally)
    warm_eng = Engine(EngineConfig(backend=backend, device=device))
    session = StreamSession(warm_eng, max_batch=max_batch,
                            batch_timeout_ms=batch_timeout_ms)
    session.add_many({sid: base for sid, (base, _) in traces.items()})
    t0 = time.perf_counter()
    last = {}
    for r in range(rounds):
        last = session.update_many({sid: deltas[r]
                                    for sid, (_, deltas) in traces.items()})
    warm_s = time.perf_counter() - t0
    stats = session.stats()
    records = [{"stream": sid, "n": session.graph(sid).n,
                "edges": session.graph(sid).num_edges,
                "communities": res.num_communities,
                "warm_started": res.warm_started,
                "lpa_iterations": res.lpa_iterations}
               for sid, res in sorted(last.items())]
    session.close()

    total_fits = num_streams * rounds
    summary = {
        "streams": num_streams, "rounds": rounds,
        "cold_s": cold_s, "warm_s": warm_s,
        "speedup": cold_s / max(warm_s, 1e-9),
        "mean_frontier_frac": stats["mean_frontier_frac"],
        "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
        "mean_batch": stats["mean_batch"],
    }
    print(f"[serve-streaming] {num_streams} streams x {rounds} rounds "
          f"({total_fits} re-detections, ~{delta_edges} edges churned each): "
          f"cold {cold_s:.2f}s, warm batched {warm_s:.2f}s "
          f"({summary['speedup']:.1f}x), frontier "
          f"{summary['mean_frontier_frac']:.1%} of vertices, mean batch "
          f"{summary['mean_batch']:.1f}, p50 {summary['p50_ms']:.0f}ms",
          flush=True)
    return records, summary


def serve_tenants(num_tenants: int = 16, rounds: int = 3,
                  size: int = 120, avg_degree: float = 5.0,
                  delta_edges: int = 4, backend: str = "auto",
                  max_batch: int = 8, batch_timeout_ms: float = 2.0,
                  queue_capacity: int = 32, warm_budget: str = "256KB",
                  client_threads: int = 8, seed: int = 0,
                  snapshot_dir: str | None = None,
                  quality: str = "off", slo_p99_ms: float | None = None,
                  device=None):
    """Drive K concurrent tenants through the multi-tenant service tier.

    Each tenant is one evolving graph served by a per-tenant
    :class:`~repro_torch.launch.stream.StreamSession`, all multiplexed over
    **one** shared Engine through **one** shared MicroBatcher behind the
    bounded admission queue (:mod:`repro_torch.serve`).  Traffic is the mixed
    cold/warm/delta trace from :mod:`repro_torch.serve.loadgen`: cold
    registers, warm delta updates with frontier seeds, periodic cold
    refreshes — clients back off and retry on explicit ``Rejected``
    backpressure.  Prints the SLO surface (aggregate edges/s, p50/p99
    latency, queue depth, rejection rate, warm-ledger peak) and, with
    ``snapshot_dir``, writes the tenants' warm state as an atomic
    checkpoint a restarted service can resume warm from.

    ``quality`` wires :attr:`repro_torch.engine.EngineConfig.quality` into the
    shared engine, so every completed fit feeds the per-tenant quality
    timelines (modularity / disconnected-fraction / churn drift alerts —
    ``stats()["health"]``) on top of latency; ``slo_p99_ms`` arms the
    p99-latency burn alert.
    """
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.serve import HealthConfig, ServiceConfig, TenantService
    from repro_torch.serve.loadgen import LoadConfig, build_traces, run_load

    cfg = LoadConfig(tenants=num_tenants, rounds=rounds, size=size,
                     avg_degree=avg_degree, delta_edges=delta_edges,
                     client_threads=client_threads, seed=seed)
    eng = Engine(EngineConfig(backend=backend, quality=quality,
                              device=device))
    service = TenantService(eng, ServiceConfig(
        queue_capacity=queue_capacity, warm_budget=warm_budget,
        max_batch=max_batch, batch_timeout_ms=batch_timeout_ms,
        health=HealthConfig(slo_p99_ms=slo_p99_ms)))
    records, summary = run_load(service, build_traces(cfg), cfg)
    health = service.stats()["health"]
    if snapshot_dir is not None:
        manifest = service.snapshot(CheckpointManager(snapshot_dir))
        print(f"[serve-tenants] snapshot step {manifest['step']}: "
              f"{len(manifest['tenants'])} tenants -> {snapshot_dir}",
              flush=True)
    service.close()
    summary["health"] = health
    if quality != "off" or slo_p99_ms is not None:
        lasts = [t["last"] for t in health["tenants"].values() if t["last"]]
        worst_disc = max((s["disconnected_fraction"] or 0.0 for s in lasts),
                         default=0.0)
        print(f"[serve-tenants] health: {len(health['tenants'])} timelines, "
              f"alerts {health['alert_counts'] or '{}'}, worst "
              f"disconnected fraction {worst_disc:g}", flush=True)
    print(f"[serve-tenants] {summary['tenants']} tenants x "
          f"{summary['rounds']} rounds: {summary['completed']} requests "
          f"({summary['stranded']} stranded, {summary['rejections']} "
          f"rejected, rate {summary['rejection_rate']:.1%}), latency p50 "
          f"{summary['p50_ms']:.0f}ms p99 {summary['p99_ms']:.0f}ms, queue "
          f"peak {summary['queue_depth_peak']}, warm bytes peak "
          f"{summary['warm_bytes_peak']} <= budget "
          f"{summary['warm_budget']}, {summary['edges_per_s']:.0f} edges/s "
          f"aggregate", flush=True)
    return records, summary


class _PeriodicStats(contextlib.AbstractContextManager):
    """Background reporter: prints the unified metrics registry every
    ``every_s`` seconds while a serving workload runs, plus one final
    snapshot on exit (``--stats-every-s``).  The final flush happens on
    ``__exit__`` — after the workload completes — so it carries whatever
    quality gauges the run populated.  An optional
    :class:`repro_torch.obs.JsonlSink` mirrors every dump as one machine-
    readable line (``--metrics-jsonl``)."""

    def __init__(self, every_s: float, sink=None):
        self._every = every_s
        self._sink = sink
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stats-reporter")

    def _dump(self, tag: str) -> None:
        from repro_torch.obs import REGISTRY
        text = REGISTRY.render_text()
        body = "\n".join("  " + line for line in text.splitlines()) \
            if text.strip() else "  (empty)"
        print(f"[stats {tag}]\n{body}", flush=True)
        if self._sink is not None:
            self._sink.emit(tag=tag)

    def _run(self) -> None:
        tick = 0
        while not self._stop.wait(self._every):
            tick += 1
            self._dump(f"t+{tick * self._every:g}s")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._dump("final")
        return False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode",
                    choices=("lm", "communities", "streaming", "tenants"),
                    default="lm")
    ap.add_argument("--arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--graph", default=None, metavar="PATH",
                    help="communities mode: serve a real graph file "
                         "(.mtx / SNAP edge list; parse-once CSR cache) "
                         "instead of the synthetic traffic mix")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda; "
                         "'cpu' runs the plain kernel versions)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="largest request batch per device dispatch")
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0,
                    help="linger after a batch's first request before "
                         "dispatching partial batches")
    ap.add_argument("--streams", type=int, default=6,
                    help="streaming mode: number of evolving graphs")
    ap.add_argument("--rounds", type=int, default=5,
                    help="streaming/tenants mode: delta rounds per stream")
    ap.add_argument("--delta-edges", type=int, default=4,
                    help="streaming/tenants mode: edges churned per delta")
    ap.add_argument("--tenants", type=int, default=16,
                    help="tenants mode: number of concurrent tenants")
    ap.add_argument("--queue-capacity", type=int, default=32,
                    help="tenants mode: global admission bound")
    ap.add_argument("--warm-budget", default="256KB",
                    help="tenants mode: global warm-labels byte budget")
    ap.add_argument("--snapshot-dir", default=None,
                    help="tenants mode: write a warm-state checkpoint "
                         "after the load (restore resumes warm)")
    ap.add_argument("--stats-every-s", type=float, default=None,
                    metavar="S",
                    help="print the unified metrics registry every S "
                         "seconds while serving (+ a final snapshot)")
    ap.add_argument("--quality", default="off",
                    choices=("off", "basic", "full"),
                    help="tenants mode: per-fit quality telemetry depth "
                         "(EngineConfig.quality) feeding the per-tenant "
                         "drift timelines")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="tenants mode: p99 latency SLO; burns raise "
                         "health alerts")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text metrics over HTTP on this "
                         "port while the workload runs (0 = ephemeral; "
                         "also /metrics.json and /healthz)")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append registry snapshots as JSONL (one line per "
                         "--stats-every-s tick + a final one)")
    a = ap.parse_args(argv)

    from repro_torch.obs import JsonlSink, MetricsServer
    sink = JsonlSink(a.metrics_jsonl) if a.metrics_jsonl else None
    server = contextlib.nullcontext()
    if a.metrics_port is not None:
        server = MetricsServer(port=a.metrics_port)
        print(f"[serve] metrics endpoint: {server.url}/metrics", flush=True)
    reporter = _PeriodicStats(a.stats_every_s, sink=sink) \
        if a.stats_every_s else contextlib.nullcontext()
    with server, reporter:
        if a.mode == "tenants":
            serve_tenants(num_tenants=a.tenants, rounds=a.rounds,
                          delta_edges=a.delta_edges, backend=a.backend,
                          max_batch=a.max_batch,
                          batch_timeout_ms=a.batch_timeout_ms,
                          queue_capacity=a.queue_capacity,
                          warm_budget=a.warm_budget,
                          snapshot_dir=a.snapshot_dir,
                          quality=a.quality, slo_p99_ms=a.slo_p99_ms,
                          device=a.device)
        elif a.mode == "communities":
            serve_communities(num_requests=a.requests, backend=a.backend,
                              max_batch=a.max_batch,
                              batch_timeout_ms=a.batch_timeout_ms,
                              graph_path=a.graph, device=a.device)
        elif a.mode == "streaming":
            serve_streaming(num_streams=a.streams, rounds=a.rounds,
                            delta_edges=a.delta_edges, backend=a.backend,
                            max_batch=a.max_batch,
                            batch_timeout_ms=a.batch_timeout_ms,
                            device=a.device)
        else:
            if not a.arch:
                ap.error("--arch is required for --mode lm")
            serve(a.arch, batch=a.batch, max_new=a.max_new,
                  device=a.device)
    if sink is not None:
        # guaranteed final flush, with or without --stats-every-s:
        # everything the run recorded, quality gauges included
        sink.emit(tag="shutdown")
        sink.close()
        print(f"[serve] metrics jsonl -> {a.metrics_jsonl}", flush=True)


if __name__ == "__main__":
    main()
