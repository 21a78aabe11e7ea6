"""Micro-batching scheduler for community-detection serving.

Small-graph traffic is dispatch-bound: one device launch per request caps
throughput far below the hardware.  :class:`MicroBatcher` drains a request
queue in batches of up to ``max_batch`` graphs, lingering up to
``batch_timeout_ms`` after the first request of a batch so concurrent
traffic can coalesce, and runs each batch as one ``Engine.fit_many``
dispatch.  Every submission resolves to the same per-graph
:class:`DetectionResult` a solo ``fit`` would return.

    eng = Engine(EngineConfig())
    with MicroBatcher(eng, max_batch=16, batch_timeout_ms=2.0) as mb:
        subs = [mb.submit(g) for g in graphs]
        results = [s.result(timeout=60) for s in subs]
    print(mb.stats())   # batch-size histogram, p50/p95 latency

Each batcher writes through to a ``batcher`` registry scope
(``requests``, ``batches``, the ``batch_size`` and ``latency_ms``
histograms; ``repro_torch.obs``), released when it closes (a scope
passed in belongs to its owner), and wraps each
dispatch and settlement in the spans ``batch.dispatch`` and
``batch.settle``.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future

import numpy as np

from repro_torch.obs import REGISTRY, span

# Histogram bucket bounds (cumulative upper edges, Prometheus-style).
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
_LATENCY_MS_BUCKETS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000)


class Submission:
    """Handle for one enqueued request; resolves to a DetectionResult."""

    def __init__(self, graph, submitted: float, init_labels=None,
                 init_active=None):
        self.graph = graph
        self.init_labels = init_labels  # warm-start labels (or None: cold)
        self.init_active = init_active  # unprocessed-seed mask (frontier)
        self.submitted = submitted      # perf_counter at submit
        self.latency_s: float | None = None   # set when the result lands
        self.batch_size: int | None = None    # size of the batch it rode in
        self._future: Future = Future()

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` when the result (or exception) lands, on the
        worker thread that settles it (or inline if already done)."""
        self._future.add_done_callback(lambda _f: fn(self))


class MicroBatcher:
    """Queue-draining micro-batch scheduler over ``Engine.fit_many``.

    max_batch: largest number of requests packed into one dispatch.
    batch_timeout_ms: linger after the first request of a batch before
      dispatching a partial batch (0 dispatches what is already queued).
    autostart: start the worker thread at once.  ``autostart=False`` lets
      callers enqueue a burst first and then :meth:`start`, which makes the
      batches deterministic.
    scope: the registry scope to write under.  ``None`` (standalone)
      claims a ``batcher`` scope, released by :meth:`close` once the
      worker has stopped; a given scope (the serving tier's
      ``serve.batcher``) belongs to its owner and is never released here.
    """

    def __init__(self, engine, max_batch: int = 8,
                 batch_timeout_ms: float = 2.0, backend: str | None = None,
                 autostart: bool = True, scope=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = max_batch
        self.batch_timeout_s = batch_timeout_ms / 1e3
        self.backend = backend
        self.batch_sizes: list[int] = []   # one entry per dispatched batch
        self._latencies: list[float] = []  # one entry per completed request
        self._own_scope = scope is None
        self._obs = REGISTRY.scope("batcher") if scope is None else scope
        self._m_requests = self._obs.counter("requests")
        self._m_batches = self._obs.counter("batches")
        self._h_batch = self._obs.histogram("batch_size", _BATCH_BUCKETS)
        self._h_latency = self._obs.histogram("latency_ms",
                                              _LATENCY_MS_BUCKETS)
        self._q: "queue.Queue[Submission | None]" = queue.Queue()
        self._lock = threading.Lock()  # orders submits against the sentinel
        self._closed = False
        self._fatal: BaseException | None = None  # the worker died of this
        self._inflight: tuple | list = ()  # batch currently in _dispatch
        self._started = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        if autostart:
            self.start()

    # --- lifecycle ---

    def start(self) -> "MicroBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self, wait: bool = True, timeout: float | None = None) -> None:
        """Stop accepting requests; drain the queue, then stop the worker
        (waiting at most ``timeout`` seconds for it when ``wait``).  An
        owned registry scope is released once the worker has stopped."""
        with self._lock:
            first = not self._closed
            if first:
                self._closed = True
                self._q.put(None)  # sentinel: drain and exit
        if first and not self._started:
            self.start()
        if wait and self._started:
            self._thread.join(timeout)
            if not self._thread.is_alive() and self._own_scope:
                self._obs.release()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- request path ---

    def submit(self, graph, init_labels=None, init_active=None) -> Submission:
        """Enqueue one detection request, with optional warm-start labels
        and unprocessed-seed mask; warm and cold requests share batches."""
        sub = Submission(graph, time.perf_counter(), init_labels, init_active)
        # The lock orders accepted submissions before close()'s sentinel
        # (FIFO queue), so every accepted submission is dispatched before
        # the worker exits: a submit racing close() lands first or raises.
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(
                    "MicroBatcher worker died; no submission will ever be "
                    "dispatched") from self._fatal
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(sub)
        self._m_requests.inc()
        return sub

    # --- worker ---

    def _run(self) -> None:
        # A crash outside _dispatch's guarded engine call fails the batch
        # in flight and every queued future, and poisons submit(), so no
        # caller waits forever on a dead worker.
        try:
            self._run_loop()
        except BaseException as e:
            self._abort(e)

    def _run_loop(self) -> None:
        stop = False
        while not stop:
            item = self._q.get()
            if item is None:
                break
            batch = [item]
            deadline = time.perf_counter() + self.batch_timeout_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = self._q.get_nowait() if remaining <= 0 \
                        else self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._inflight = batch
            self._dispatch(batch)
            self._inflight = ()
        # FIFO and the submit/close lock make the sentinel the last item
        # ever enqueued, so reaching it means the queue is drained.

    def _abort(self, exc: BaseException) -> None:
        with self._lock:
            self._fatal = exc
            self._closed = True
        for s in self._inflight:
            if not s._future.done():
                s._future.set_exception(exc)
        self._inflight = ()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item._future.done():
                item._future.set_exception(exc)

    def _dispatch(self, batch: list[Submission]) -> None:
        try:
            # warm-start lists only when some request carries them, so
            # cold traffic keeps the bare fit_many(graphs, backend=...) call
            kwargs = {}
            if any(s.init_labels is not None for s in batch):
                kwargs["init_labels"] = [s.init_labels for s in batch]
            if any(s.init_active is not None for s in batch):
                kwargs["init_active"] = [s.init_active for s in batch]
            with span("batch.dispatch", size=len(batch)):
                results = self.engine.fit_many([s.graph for s in batch],
                                               backend=self.backend,
                                               **kwargs)
        except BaseException as e:  # propagate to every waiter
            for s in batch:
                s._future.set_exception(e)
            return
        now = time.perf_counter()
        # settlement under its own span, so the latency histogram's
        # exemplars carry a span id
        with span("batch.settle", size=len(batch)):
            with self._lock:
                self.batch_sizes.append(len(batch))
                for s in batch:
                    s.latency_s = now - s.submitted
                    s.batch_size = len(batch)
                    self._latencies.append(s.latency_s)
            self._m_batches.inc()
            self._h_batch.observe(len(batch))
            for s, res in zip(batch, results):
                self._h_latency.observe(s.latency_s * 1e3)
                s._future.set_result(res)

    # --- observability ---

    def stats(self) -> dict:
        """Requests, batches, batch-size histogram and latency
        percentiles of the requests served so far."""
        with self._lock:
            sizes = list(self.batch_sizes)
            lat_ms = np.asarray(self._latencies) * 1e3
        out = {
            "requests": len(lat_ms),
            "batches": len(sizes),
            "batch_size_hist": dict(sorted(Counter(sizes).items())),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
        }
        if len(lat_ms):
            out.update(p50_ms=float(np.percentile(lat_ms, 50)),
                       p95_ms=float(np.percentile(lat_ms, 95)),
                       mean_ms=float(np.mean(lat_ms)))
        else:
            out.update(p50_ms=0.0, p95_ms=0.0, mean_ms=0.0)
        return out
