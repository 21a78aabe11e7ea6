"""Bounded, tenant-fair request admission with explicit backpressure.

The serving tier's front door: every request from every tenant lands in
one :class:`AdmissionQueue` with a **global capacity bound** — when the
queue is full, :meth:`AdmissionQueue.offer` raises :class:`Rejected`
carrying a ``retry_after_s`` hint instead of growing without bound (the
caller sleeps and retries; nothing is silently dropped, nothing queues
forever).

Dequeue order is **round-robin across tenants**: each tenant has its own
FIFO, and :meth:`AdmissionQueue.take` serves the next tenant in rotation
that (a) has queued work and (b) is not *held*.  A tenant is held from
the moment one of its requests is taken until the service calls
:meth:`AdmissionQueue.release` — the one-in-flight-per-tenant rule that
both keeps per-tenant request order (a delta must apply to the graph its
predecessor produced) and makes the rotation an actual fairness
guarantee: a tenant flooding its FIFO only ever occupies one dispatch
slot per cycle, so a quiet tenant's single request is served within one
rotation, not behind the flood.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict, deque

from repro_torch.obs import CappedCounterSet


class Rejected(RuntimeError):
    """Backpressure: the global admission queue is full.

    Carries ``retry_after_s`` — the client-facing hint for when to retry.
    This is the *only* way the serving tier sheds load: a request is
    either rejected here, visibly, or it is admitted and will resolve
    (with a result or an exception).  Nothing in between.
    """

    def __init__(self, depth: int, capacity: int, retry_after_s: float):
        self.depth = depth
        self.capacity = capacity
        self.retry_after_s = retry_after_s
        super().__init__(
            f"admission queue full ({depth}/{capacity}); "
            f"retry after {retry_after_s:.3f}s")


class AdmissionQueue:
    """Global-capacity, per-tenant-FIFO, round-robin-drained queue.

    capacity: hard bound on queued (not yet taken) requests across all
      tenants; ``offer`` past it raises :class:`Rejected`.
    retry_after_s: the hint attached to rejections.
    served_label_cap: how many tenants get a dedicated
      ``served.<tenant>`` registry counter; later tenants share
      ``served.other`` (see :class:`repro_torch.obs.CappedCounterSet`).
    """

    def __init__(self, capacity: int, retry_after_s: float = 0.05,
                 scope=None, served_label_cap: int = 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.retry_after_s = float(retry_after_s)
        self._cond = threading.Condition()
        # tenant -> FIFO of queued items; dict order IS the rotation:
        # a served tenant is moved to the back of the cycle.
        self._fifos: OrderedDict[object, deque] = OrderedDict()
        self._held: set = set()
        self._closed = False
        self.depth = 0
        self.peak_depth = 0
        self.accepted = 0
        self.rejected = 0
        self.served: Counter = Counter()   # tenant -> requests taken
        # Registry write-through; the fields above stay authoritative.
        # Per-tenant served counts enter the registry through a *capped*
        # label space (first ``served_label_cap`` tenants get their own
        # ``served.<tenant>`` counter, the rest share ``served.other``) —
        # tenant ids are unbounded, registry cardinality must not be.
        # Exact per-tenant numbers stay in ``stats()``.
        self._served_metrics = CappedCounterSet(
            scope, "served", max_labels=served_label_cap) if scope else None
        self._m_accepted = scope.counter("accepted") if scope else None
        self._m_rejected = scope.counter("rejected") if scope else None
        self._m_taken = scope.counter("taken") if scope else None
        self._g_depth = scope.gauge("depth") if scope else None
        self._g_peak = scope.gauge("peak_depth") if scope else None
        self._g_held = scope.gauge("held") if scope else None

    # --- producer side ---

    def offer(self, tenant, item) -> None:
        """Enqueue one request, or raise :class:`Rejected` when full."""
        with self._cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            if self.depth >= self.capacity:
                self.rejected += 1
                if self._m_rejected is not None:
                    self._m_rejected.inc()
                raise Rejected(self.depth, self.capacity, self.retry_after_s)
            fifo = self._fifos.get(tenant)
            if fifo is None:
                fifo = self._fifos[tenant] = deque()
            fifo.append(item)
            self.depth += 1
            self.peak_depth = max(self.peak_depth, self.depth)
            self.accepted += 1
            if self._m_accepted is not None:
                self._m_accepted.inc()
                self._g_depth.set(self.depth)
                self._g_peak.set(self.peak_depth)
            self._cond.notify()

    def close(self) -> None:
        """Stop accepting; queued work remains takeable (drain mode)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # --- consumer side (the dispatcher) ---

    def take(self, timeout: float | None = None):
        """Next ``(tenant, item)`` in rotation; holds the tenant.

        Skips held tenants (their next request becomes eligible on
        :meth:`release`).  Returns None on timeout, or immediately when
        the queue is closed and drained.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                for tenant, fifo in self._fifos.items():
                    if tenant in self._held or not fifo:
                        continue
                    item = fifo.popleft()
                    self.depth -= 1
                    self._held.add(tenant)
                    self.served[tenant] += 1
                    # back of the cycle: round-robin fairness
                    self._fifos.move_to_end(tenant)
                    if not fifo:
                        del self._fifos[tenant]
                    if self._m_taken is not None:
                        self._m_taken.inc()
                        self._g_depth.set(self.depth)
                        self._g_held.set(len(self._held))
                    if self._served_metrics is not None:
                        self._served_metrics.inc(tenant)
                    return tenant, item
                if self._closed and self.depth == 0:
                    return None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def release(self, tenant) -> None:
        """The tenant's in-flight request settled; its next queued
        request becomes takeable."""
        with self._cond:
            self._held.discard(tenant)
            if self._g_held is not None:
                self._g_held.set(len(self._held))
            self._cond.notify_all()

    # --- observability ---

    def drained(self) -> bool:
        with self._cond:
            return self._closed and self.depth == 0

    def stats(self) -> dict:
        with self._cond:
            return {
                "capacity": self.capacity,
                "depth": self.depth,
                "peak_depth": self.peak_depth,
                "accepted": self.accepted,
                "rejected": self.rejected,
                "held": len(self._held),
                "tenants_queued": len(self._fifos),
                "served_per_tenant": dict(self.served),
            }
