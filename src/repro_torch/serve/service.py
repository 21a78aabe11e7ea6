"""Multi-tenant community-detection serving over one shared Engine.

:class:`TenantService` multiplexes N tenants — each an evolving-graph
:class:`~repro_torch.launch.stream.StreamSession` — over **one** shared
:class:`~repro_torch.engine.Engine` through **one** shared
:class:`~repro_torch.launch.microbatch.MicroBatcher`, so concurrent tenants'
updates coalesce into single ``fit_many`` device dispatches while every
tenant keeps its own warm labels, versions, and counters.  Per-member
results stay bit-identical to a solo warm ``fit`` (the engine's parity
contract, extended to this path by tests/test_torch_serve.py).

The moving parts:

* **Admission** (:mod:`repro_torch.serve.admission`): every request enters a
  bounded global queue with per-tenant FIFOs drained round-robin; a full
  queue rejects with a ``retry_after_s`` hint (explicit backpressure —
  the queue never grows without bound, and an admitted request always
  resolves).  One request per tenant is in flight at a time, which both
  preserves per-tenant delta order and makes the rotation fair.
* **Dispatch**: a single dispatcher thread takes admitted requests,
  applies deltas (splice-patch vs rebuild via the engine's measured
  churn threshold — the per-tenant ``StreamSession`` owns that), and
  submits to the shared batcher *without waiting*: settlement happens in
  a completion callback, so up to ``max_batch`` different tenants ride
  one device dispatch.
* **Warm-state budget**: every tenant's committed labels are charged to
  a shared :class:`~repro_torch.partition.slices.MemoryLedger`.  When a commit
  would exceed the budget, the least-recently-served tenants' warm
  labels **spill** (drop to cold — correctness is unaffected, the next
  update just re-detects from singletons) until the newcomer fits.  The
  ledger's ``peak`` is the asserted bound in the load harness.
* **Snapshot/restore** (:mod:`repro_torch.checkpoint.manager`): the committed
  per-tenant labels + graph fingerprints write as one atomic checkpoint;
  a restarted service re-seeds them (fingerprint-verified) so tenants
  resume *warm* — no cold re-detection storm after a restart.

    eng = Engine(EngineConfig())             # CUDA; device="cpu" here
    svc = TenantService(eng, ServiceConfig(queue_capacity=64,
                                           warm_budget="1MB"))
    svc.register("acme", graph).result()
    ticket = svc.update("acme", delta)       # async; Rejected => backoff
    res = ticket.result()
    svc.snapshot(CheckpointManager(path))
    svc.close()
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np

from repro_torch.core.graph import Graph, graph_fingerprint
from repro_torch.launch.microbatch import MicroBatcher
from repro_torch.launch.stream import (
    PreparedUpdate,
    StreamSession,
    StreamState,
)
from repro_torch.obs import REGISTRY, span
from repro_torch.partition.plan import parse_bytes
from repro_torch.partition.slices import MemoryLedger
from repro_torch.serve.admission import AdmissionQueue
from repro_torch.serve.health import (
    HealthConfig,
    HealthMonitor,
    sample_from_result,
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs for :class:`TenantService`.

    queue_capacity / retry_after_s: the admission bound and the hint
      attached to :class:`~repro_torch.serve.admission.Rejected`.
    warm_budget: global byte budget for tenants' warm labels (bytes or
      ``"64KB"``-style; None = unbounded).  Over-budget commits spill
      the least-recently-served tenants to cold.
    max_batch / batch_timeout_ms / backend: shared micro-batcher knobs.
    warm / frontier: per-tenant session semantics (see
      :class:`~repro_torch.launch.stream.StreamSession`).
    health: drift/SLO thresholds for the per-tenant quality timelines
      (:class:`~repro_torch.serve.health.HealthMonitor`).  Samples carry
      quality fields only when the shared engine runs with
      ``EngineConfig.quality != "off"``; latency SLO burn works either
      way.
    served_label_cap: how many tenants get a dedicated
      ``admission.served.<tenant>`` registry counter before the rest
      share ``admission.served.other`` (cardinality bound; exact
      per-tenant counts stay in ``stats()``).
    """
    queue_capacity: int = 64
    retry_after_s: float = 0.05
    warm_budget: int | str | None = None
    max_batch: int = 8
    batch_timeout_ms: float = 2.0
    backend: str | None = None
    warm: bool = True
    frontier: bool = True
    health: "HealthConfig | None" = None
    served_label_cap: int = 16


class TenantTicket:
    """Client handle for one admitted request; resolves to the
    :class:`~repro_torch.engine.DetectionResult` (or the request's
    exception)."""

    def __init__(self, tenant, kind: str):
        self.tenant = tenant
        self.kind = kind                    # register | update | refresh
        self.submitted = time.perf_counter()
        self.latency_s: float | None = None
        self._future: Future = Future()

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)

    def done(self) -> bool:
        return self._future.done()


@dataclasses.dataclass
class _Request:
    tenant: object
    kind: str                   # register | update | refresh
    payload: object             # Graph | GraphDelta | None
    ticket: TenantTicket


class TenantService:
    """N tenants, one engine, one batcher — admission-controlled.

    ``engine`` is shared by every tenant (its compile + warm caches are
    thread-safe); pass ``batcher`` to share a scheduler with other
    services, otherwise one is owned.  All public methods are
    thread-safe: many client threads may register/update concurrently.
    """

    _STREAM = "g"   # the single stream key inside each tenant's session

    def __init__(self, engine, config: ServiceConfig | None = None,
                 batcher: MicroBatcher | None = None):
        self.engine = engine
        self.config = config if config is not None else ServiceConfig()
        cfg = self.config
        # Per-instance registry scope; children hang off it so the
        # hierarchy reads serve.admission.*, serve.warm.*, serve.batcher.*
        # (a shared batcher keeps whatever scope its owner gave it).
        self._obs = REGISTRY.scope("serve")
        self._own_batcher = batcher is None
        self.batcher = batcher if batcher is not None else MicroBatcher(
            engine, max_batch=cfg.max_batch,
            batch_timeout_ms=cfg.batch_timeout_ms, backend=cfg.backend,
            scope=self._obs.scope("batcher"))
        self.admission = AdmissionQueue(cfg.queue_capacity,
                                        retry_after_s=cfg.retry_after_s,
                                        scope=self._obs.scope("admission"),
                                        served_label_cap=cfg.served_label_cap)
        self.health = HealthMonitor(cfg.health or HealthConfig(),
                                    scope=self._obs.scope("health"))
        budget = None if cfg.warm_budget is None \
            else parse_bytes(cfg.warm_budget)
        self.ledger = MemoryLedger(budget, scope=self._obs.scope("warm"))

        self._lock = threading.RLock()
        self._sessions: dict = {}               # tenant -> StreamSession
        self._warm_lru: OrderedDict = OrderedDict()  # tenant -> charged bytes
        self._latencies: list[float] = []
        self._outstanding = 0
        self._done_cond = threading.Condition(self._lock)
        self.completed = 0
        self.failed = 0
        self.spills = 0       # warm labels dropped to fit the budget
        self.uncached = 0     # commits too large to cache even after spill
        self.restored = 0     # tenants re-seeded warm from a checkpoint
        self._m_completed = self._obs.counter("completed")
        self._m_failed = self._obs.counter("failed")
        self._m_spills = self._obs.counter("spills")
        self._m_uncached = self._obs.counter("uncached")
        self._m_restored = self._obs.counter("restored")
        self._g_outstanding = self._obs.gauge("outstanding")
        self._g_tenants = self._obs.gauge("tenants")
        self._h_latency = self._obs.histogram(
            "latency_ms", (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000))

        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="tenant-dispatcher")
        self._dispatcher.start()

    # --- lifecycle ---

    def __enter__(self) -> "TenantService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, wait: bool = True) -> None:
        """Stop admitting; drain every outstanding request, then stop."""
        self.admission.close()
        if wait:
            with self._done_cond:
                while self._outstanding > 0:
                    self._done_cond.wait(timeout=1.0)
        self._dispatcher.join()
        if self._own_batcher:
            self.batcher.close()
        # drop this instance's metrics (children release by prefix)
        self._obs.release()

    # --- client surface ---

    def register(self, tenant, graph: Graph) -> TenantTicket:
        """Admit a tenant with its initial graph (cold first detection).

        Raises :class:`~repro_torch.serve.admission.Rejected` under
        backpressure and ``ValueError`` on duplicate registration.  The
        graph is kept on the host (the delta code is host numpy); the
        engine moves it to its device for each fit.
        """
        graph = graph.to("cpu")
        with self._lock:
            if tenant in self._sessions:
                raise ValueError(f"tenant {tenant!r} already registered")
            # per-tenant session sharing the service batcher; its own
            # close() is a no-op for shared batchers
            self._sessions[tenant] = StreamSession(
                self.engine, warm=self.config.warm,
                frontier=self.config.frontier, batcher=self.batcher)
        return self._admit(_Request(tenant, "register", graph,
                                    TenantTicket(tenant, "register")))

    def update(self, tenant, delta) -> TenantTicket:
        """Admit one delta update (warm incremental re-detection)."""
        self._known(tenant)
        return self._admit(_Request(tenant, "update", delta,
                                    TenantTicket(tenant, "update")))

    def refresh(self, tenant) -> TenantTicket:
        """Admit a cold full re-detection of the tenant's current graph
        (ignores warm labels — the periodic drift-correction request)."""
        self._known(tenant)
        return self._admit(_Request(tenant, "refresh", None,
                                    TenantTicket(tenant, "refresh")))

    def labels(self, tenant) -> np.ndarray | None:
        with self._lock:
            st = self._state(tenant)
            return None if st is None else st.labels

    def graph(self, tenant) -> Graph:
        with self._lock:
            st = self._state(tenant)
            if st is None:
                raise KeyError(f"tenant {tenant!r} has no committed graph")
            return st.graph

    def tenants(self) -> list:
        with self._lock:
            return list(self._sessions)

    # --- internals ---

    def _known(self, tenant) -> None:
        with self._lock:
            if tenant not in self._sessions:
                raise KeyError(f"tenant {tenant!r} is not registered")

    def _state(self, tenant) -> StreamState | None:
        sess = self._sessions.get(tenant)
        if sess is None:
            return None
        return sess.streams.get(self._STREAM)

    def _admit(self, req: _Request) -> TenantTicket:
        with span("serve.admit", kind=req.kind):
            try:
                self.admission.offer(req.tenant, req)
            except BaseException:
                if req.kind == "register":
                    # a rejected register never happened: allow the retry
                    with self._lock:
                        self._sessions.pop(req.tenant, None)
                raise
        with self._lock:
            self._outstanding += 1
            self._g_outstanding.set(self._outstanding)
            self._g_tenants.set(len(self._sessions))
        return req.ticket

    def _dispatch_loop(self) -> None:
        admission = self.admission
        while True:
            got = admission.take(timeout=0.05)
            if got is None:
                if admission.drained():
                    break
                continue
            tenant, req = got
            try:
                self._launch(req)
            except BaseException as e:
                # launch-side failure (bad delta, unregistered stream,
                # closed batcher): this request fails, siblings don't
                self._finish(req, None, e)

    def _launch(self, req: _Request) -> None:
        sess = self._sessions[req.tenant]
        with span("serve.launch", kind=req.kind):
            if req.kind == "register":
                prep: object = req.payload        # the initial Graph
                sub = self.batcher.submit(req.payload)
            elif req.kind == "update":
                # prepare under the service lock: a concurrent commit may
                # spill *this* tenant's labels mid-prepare otherwise
                with self._lock:
                    prep = sess.prepare_update(self._STREAM, req.payload)
                sub = self.batcher.submit(prep.graph,
                                          init_labels=prep.init_labels,
                                          init_active=prep.init_active)
            else:  # refresh: cold re-fit of the committed graph
                with self._lock:
                    prep = sess.streams[self._STREAM].graph
                sub = self.batcher.submit(prep)
        sub.add_done_callback(
            lambda s, req=req, prep=prep: self._settle(req, prep, s))

    def _settle(self, req: _Request, prep, sub) -> None:
        """Completion callback (runs on the batcher worker): commit the
        tenant's state and resolve the client ticket.  Defensive to the
        bone — any exception here must land in the ticket, never strand
        it."""
        try:
            with span("serve.settle", kind=req.kind):
                exc = sub.exception()
                if exc is not None:
                    self._finish(req, None, exc)
                    return
                res = sub.result()
                with self._lock:
                    sess = self._sessions[req.tenant]
                    if isinstance(prep, PreparedUpdate):
                        sess.commit_update(self._STREAM, prep, res)
                    elif req.kind == "register":
                        sess.streams[self._STREAM] = StreamState(
                            graph=prep, labels=res.labels)
                    else:  # refresh: same graph, fresh cold labels
                        st = sess.streams[self._STREAM]
                        st.labels = res.labels
                    self._account_warm(req.tenant)
                self._finish(req, res, None)
        except BaseException as e:
            self._finish(req, None, e)

    def _finish(self, req: _Request, res, exc) -> None:
        now = time.perf_counter()
        with self._lock:
            req.ticket.latency_s = now - req.ticket.submitted
            if exc is None:
                self.completed += 1
                self._latencies.append(req.ticket.latency_s)
                self._m_completed.inc()
                self._h_latency.observe(req.ticket.latency_s * 1e3)
            else:
                self.failed += 1
                self._m_failed.inc()
            self._outstanding -= 1
            self._g_outstanding.set(self._outstanding)
            self._done_cond.notify_all()
        if exc is None:
            # Feed the tenant's quality/SLO timeline (drift detection);
            # outside self._lock — the monitor has its own, and per-tenant
            # ordering holds because one request per tenant is in flight.
            self.health.record(req.tenant, sample_from_result(
                res, kind=req.kind, latency_ms=req.ticket.latency_s * 1e3))
        # release before resolving: the tenant's next queued request can
        # start coalescing into the batch the client's reaction would miss
        self.admission.release(req.tenant)
        if exc is None:
            req.ticket._future.set_result(res)
        else:
            req.ticket._future.set_exception(exc)

    # --- warm-state budget (callers hold self._lock) ---

    def _account_warm(self, tenant) -> None:
        """Charge the tenant's committed labels to the shared ledger,
        spilling least-recently-served tenants' warm labels to fit."""
        st = self._state(tenant)
        old = self._warm_lru.pop(tenant, 0)
        if old:
            self.ledger.release(old)
        if st is None or st.labels is None:
            return
        nbytes = int(st.labels.nbytes)
        while not self.ledger.try_acquire(nbytes, f"warm labels {tenant!r}"):
            victim = next(iter(self._warm_lru), None)
            if victim is None:
                # nothing left to spill: this tenant runs cold next time
                st.labels = None
                self.uncached += 1
                self._m_uncached.inc()
                return
            self._spill(victim)
        self._warm_lru[tenant] = nbytes   # most-recently served

    def _spill(self, victim) -> None:
        nbytes = self._warm_lru.pop(victim)
        self.ledger.release(nbytes)
        st = self._state(victim)
        if st is not None:
            st.labels = None              # cold next update; still correct
        self.spills += 1
        self._m_spills.inc()

    # --- snapshot / restore ---

    def snapshot(self, manager, step: int | None = None) -> dict:
        """Write every tenant's committed warm state as one atomic
        checkpoint (labels + graph fingerprint + version).

        ``manager`` is a :class:`repro_torch.checkpoint.CheckpointManager`
        (or the JAX package's: the files are the same);
        the write inherits its atomic tmp+rename and keep-k GC.  Tenants
        whose labels are currently spilled snapshot as cold (their
        fingerprint still records membership).  Returns the manifest
        metadata that was saved.
        """
        with self._lock:
            arrays: dict[str, np.ndarray] = {}
            meta: dict[str, dict] = {}
            for i, tenant in enumerate(sorted(self._sessions, key=str)):
                st = self._state(tenant)
                if st is None:
                    continue                       # register still in flight
                entry = {"index": i, "version": st.version,
                         "fingerprint": list(graph_fingerprint(st.graph)),
                         "warm": st.labels is not None}
                if st.labels is not None:
                    arrays[f"t{i}/labels"] = st.labels
                meta[str(tenant)] = entry
            if step is None:
                step = self.completed
        manager.save(step, arrays, extra={"tenants": meta})
        return {"step": step, "tenants": meta}

    def restore(self, manager, graphs: dict, step: int | None = None) -> dict:
        """Re-seed tenants from a checkpoint — warm across restarts.

        ``graphs`` maps tenant id -> its current :class:`Graph` (the
        graphs themselves live in the clients / the CSR store; the
        checkpoint holds only labels + fingerprints).  A tenant whose
        graph fingerprint matches the snapshot is registered *without
        any fit*, its warm labels re-attached — the next update is a
        warm incremental re-detection, exactly as if the process never
        restarted.  Mismatched or snapshot-cold tenants are reported
        (register them cold via :meth:`register`).  Returns a report:
        ``{"restored": [...], "mismatched": [...], "cold": [...],
        "unknown": [...]}``.
        """
        named, _step, extra = manager.load_named(step)
        meta = extra.get("tenants", {})
        report: dict[str, list] = {"restored": [], "mismatched": [],
                                   "cold": [], "unknown": []}
        for tenant, graph in graphs.items():
            entry = meta.get(str(tenant))
            if entry is None:
                report["unknown"].append(tenant)
                continue
            key = f"t{entry['index']}/labels"
            if not entry.get("warm") or key not in named:
                report["cold"].append(tenant)
                continue
            if list(graph_fingerprint(graph)) != list(entry["fingerprint"]):
                report["mismatched"].append(tenant)
                continue
            labels = np.asarray(named[key], dtype=np.int32)
            graph = graph.to("cpu")
            with self._lock:
                if tenant in self._sessions:
                    raise ValueError(
                        f"tenant {tenant!r} already registered")
                sess = StreamSession(
                    self.engine, warm=self.config.warm,
                    frontier=self.config.frontier, batcher=self.batcher)
                sess.streams[self._STREAM] = StreamState(
                    graph=graph, labels=labels,
                    version=int(entry.get("version", 0)))
                self._sessions[tenant] = sess
                self._account_warm(tenant)
                self.restored += 1
                self._m_restored.inc()
                self._g_tenants.set(len(self._sessions))
            report["restored"].append(tenant)
        return report

    # --- observability ---

    def stats(self) -> dict:
        """Service counters + admission + ledger + batcher stats."""
        with self._lock:
            lat_ms = np.asarray(self._latencies) * 1e3
            out = {
                "tenants": len(self._sessions),
                "outstanding": self._outstanding,
                "completed": self.completed,
                "failed": self.failed,
                "spills": self.spills,
                "uncached": self.uncached,
                "restored": self.restored,
                "warm_cached_tenants": len(self._warm_lru),
                "warm_bytes": {**self.ledger.stats()},
            }
        if len(lat_ms):
            out.update(p50_ms=float(np.percentile(lat_ms, 50)),
                       p99_ms=float(np.percentile(lat_ms, 99)),
                       mean_ms=float(np.mean(lat_ms)))
        else:
            out.update(p50_ms=0.0, p99_ms=0.0, mean_ms=0.0)
        out["admission"] = self.admission.stats()
        out["batcher"] = self.batcher.stats()
        out["health"] = self.health.stats()
        return out
