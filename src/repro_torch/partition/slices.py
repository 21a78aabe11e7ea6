"""Zero-copy partition loading under an explicit resident-byte budget.

The out-of-core contract is *semi-external*: O(n) vertex-indexed state
(labels, active flags, ``row_ptr``, degrees) stays resident on the host for
the whole fit, while the O(m) edge arrays only ever appear as
per-partition windows.  This module owns that edge side:

* an array source yields ``src`` / ``dst`` / ``wgt`` windows — either
  zero-copy slices of the store's single map of ``arrays.bin``
  (:class:`StoreEntrySource`) or host views of an already-built
  :class:`~repro_torch.core.graph.Graph` (:class:`InMemorySource`, the
  parity-testing path);
* a :class:`MemoryLedger` accounts every edge-proportional allocation an
  out-of-core fit makes (local index remaps, padded device inputs,
  neighbor tiles, cached label views) and **hard-fails** past the budget;
* a :class:`SliceLoader` LRU-caches resident partitions inside the
  budget: a generous budget keeps every partition warm after the first
  sweep, a tight one degrades to one-resident-at-a-time.  ``prefetch=True``
  adds a one-slot background stage: the *next* partition's window and its
  device inputs are built on a worker thread while the current one sweeps,
  with the staged bytes reserved in the ledger **before** the thread
  starts (the budget is never transiently overshot, and a prefetch that
  cannot fit is skipped).  On CUDA the worker uploads on a stream of its
  own; the calling thread waits on an event recorded after those copies
  before a kernel reads them (the ``stage`` / ``adopt`` pair of the
  loader's ``prepare`` object, ``repro_torch.partition.ooc._Prepare``);
* a :class:`HaloLabelCache` keeps per-partition label views on the
  device, keyed by partition id and refreshed by epoch: when a resident
  partition re-sweeps, only the entries whose vertex changed since the
  cached epoch are uploaded (``index_copy_``); the full host gather is
  skipped.  Cache bytes are ledger-charged and spill (LRU) whenever a
  window load needs the room, so windows always win.

Window *reads* from a map are paged in lazily by the OS; the ledger
charges them while held because a sweep touches every byte.  The JAX
package's ``repro.partition.slices`` is the reference: the same windows,
remaps, charges and eviction order.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.engine.registry import to_device
from repro_torch.partition.plan import Partition, PartitionPlan

EDGE_ARRAYS = ("src", "dst", "wgt")


class PartitionShapes:
    """Uniform padded shapes shared by every partition of one run.

    n_loc: padded local row count (owned + halo rows; the label and active
      vectors' length, and the segment backend's local-Graph ``n``).
    m: padded edge-window length (multiple of 128).
    rows: padded owned-row count (the tile backend's tile height).
    d: tile width: the in-core fit's degree bucket, so a partition row is
      folded at the in-core width and slot order.
    """

    def __init__(self, n_loc: int, m: int, rows: int, d: int):
        self.n_loc, self.m, self.rows, self.d = n_loc, m, rows, d

    def __repr__(self):
        return (f"PartitionShapes(n_loc={self.n_loc}, m={self.m}, "
                f"rows={self.rows}, d={self.d})")


class MemoryBudgetExceeded(RuntimeError):
    """A single partition's resident set cannot fit the byte budget."""


class MemoryLedger:
    """Tracks resident edge-proportional bytes against a hard budget.

    Thread-safe: the prefetching :class:`SliceLoader` reserves staged
    bytes from the calling thread before its worker runs, and the lock
    keeps the invariant whole if callers ever account from both.
    ``scope``: optional registry scope (``repro_torch.obs``) whose
    ``bytes_current`` / ``bytes_peak`` / ``bytes_budget`` gauges mirror
    the int fields, which stay authoritative.
    """

    def __init__(self, budget: int | None, scope=None):
        self.budget = None if budget is None else int(budget)
        self.current = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._g_current = scope.gauge("bytes_current") if scope else None
        self._g_peak = scope.gauge("bytes_peak") if scope else None
        if scope and self.budget is not None:
            scope.gauge("bytes_budget").set(self.budget)

    def _publish(self) -> None:
        if self._g_current is not None:
            self._g_current.set(self.current)
            self._g_peak.set(self.peak)

    def acquire(self, nbytes: int, what: str = "") -> int:
        nbytes = int(nbytes)
        if not self.try_acquire(nbytes):
            raise MemoryBudgetExceeded(
                f"acquiring {nbytes} bytes for {what or 'a partition'} "
                f"would put {self.current + nbytes} resident edge bytes "
                f"over the {self.budget}-byte budget")
        return nbytes

    def try_acquire(self, nbytes: int, what: str = "") -> bool:
        """:meth:`acquire` that returns False instead of raising, for
        callers with an eviction policy of their own (the serving tier
        spills least-recently-served tenants and retries).  ``what`` is
        kept for the reference's signature."""
        nbytes = int(nbytes)
        with self._lock:
            if (self.budget is not None
                    and self.current + nbytes > self.budget):
                return False
            self.current += nbytes
            self.peak = max(self.peak, self.current)
        self._publish()
        return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.current -= int(nbytes)
        self._publish()

    def stats(self) -> dict:
        return {"budget": self.budget, "current": self.current,
                "peak": self.peak}


# --- array sources ---------------------------------------------------------

class StoreEntrySource:
    """Windows straight off a :class:`repro_torch.io.store.EntryHandle`.

    The handle maps ``arrays.bin`` once; every window is a zero-copy slice
    of that map, so the full edge arrays are never materialized.
    """

    def __init__(self, handle):
        self.handle = handle
        self.n = int(handle.n)
        self.num_edges = int(handle.num_edges)
        self.m_pad = int(handle.m_pad)

    def row_ptr(self) -> np.ndarray:
        return self.handle.array("row_ptr")

    def window(self, name: str, lo: int, hi: int) -> np.ndarray:
        return self.handle.window(name, lo, hi)

    def fingerprint(self):
        return self.handle.fingerprint

    def to_graph(self):
        """The full in-core host Graph (no re-open, no re-hash)."""
        return self.handle.to_graph()


class InMemorySource:
    """Windows over an already-built Graph's arrays, on the host.

    The graph is by definition already in core, so this source serves
    parity tests and partitioned fits of graphs that fit in memory but
    whose per-fit working set (device copies, tiles) should not; the
    ledger still charges only the per-partition windows.  A graph on the
    card is copied to the host once.
    """

    def __init__(self, graph):
        self.graph = graph
        self.n = int(graph.n)
        self.num_edges = int(graph.num_edges)
        self.m_pad = int(graph.m_pad)
        self._arrays = {name: getattr(graph, name).cpu().numpy()
                        for name in ("row_ptr", *EDGE_ARRAYS)}

    def row_ptr(self) -> np.ndarray:
        return self._arrays["row_ptr"]

    def window(self, name: str, lo: int, hi: int) -> np.ndarray:
        return self._arrays[name][lo:hi]

    def fingerprint(self):
        from repro_torch.core.graph import graph_fingerprint
        return graph_fingerprint(self.graph)

    def to_graph(self):
        return self.graph


# --- resident partitions ---------------------------------------------------

@dataclasses.dataclass
class ResidentPartition:
    """One partition's loaded, locally indexed slice (+ prepared inputs).

    Local row space: rows ``[0, size)`` are the owned vertices
    ``[lo, hi)``, rows ``[size, n_local)`` the halo imports.  ``src`` /
    ``dst`` are remapped into that space; ``wgt`` is the raw window.
    ``inputs`` holds the backend's device inputs (padded local CSR or
    neighbor tiles) for as long as the partition stays resident.
    """
    part: Partition
    local_ids: np.ndarray   # (n_local,) int32 global id per local row
    row_ptr: np.ndarray     # (size + 1,) int32 window offsets per owned row
    src: np.ndarray         # (window,) int32 local source rows
    dst: np.ndarray         # (window,) int32 local destination rows
    wgt: np.ndarray         # (window,) float32
    nbytes: int             # ledger charge for the arrays above
    inputs: object = None   # backend-prepared device inputs
    inputs_nbytes: int = 0

    @property
    def size(self) -> int:
        return self.part.size

    @property
    def n_local(self) -> int:
        return self.part.n_local


def load_partition(source, part: Partition) -> ResidentPartition:
    """Slice and locally remap one partition's edge window.

    Owned destinations shift by ``-lo``; halo destinations map to
    ``size + rank`` by binary search in the (sorted) halo set.  The remap
    is recomputed on every load rather than kept: it is edge-proportional,
    so keeping it for *all* partitions is what the budget forbids.
    """
    if part.halo is None:
        raise ValueError(f"partition {part.index} has no halo set; run "
                         "attach_halos on the plan first")
    lo, hi = part.lo, part.hi
    src_w = source.window("src", part.e_lo, part.e_hi)
    dst_w = source.window("dst", part.e_lo, part.e_hi)
    wgt_w = np.asarray(source.window("wgt", part.e_lo, part.e_hi),
                       dtype=np.float32)
    row_ptr = (np.asarray(source.window("row_ptr", lo, hi + 1),
                          dtype=np.int64) - part.e_lo).astype(np.int32)

    # vertex ids are int32 and lo <= every source < hi: the int32
    # differences are exact, with no int64 copy of the window
    src = np.subtract(src_w, lo, dtype=np.int32)
    dst = np.subtract(dst_w, lo, dtype=np.int32)
    outside = np.nonzero((dst_w < lo) | (dst_w >= hi))[0]
    # only the halo edges need the search
    dst[outside] = part.size + np.searchsorted(part.halo, dst_w[outside])

    local_ids = part.local_ids()
    nbytes = (src.nbytes + dst.nbytes + wgt_w.nbytes + local_ids.nbytes
              + row_ptr.nbytes)
    return ResidentPartition(part=part, local_ids=local_ids, row_ptr=row_ptr,
                             src=src, dst=dst, wgt=wgt_w, nbytes=nbytes)


def slice_nbytes(part: Partition) -> int:
    """A-priori ledger charge of :func:`load_partition`'s arrays."""
    return part.num_edges * 12 + part.n_local * 4 + (part.size + 1) * 4


class SliceLoader:
    """Budget-bounded LRU of resident partitions.

    ``load(i, prepare)`` returns partition *i* resident with its backend
    inputs built; least-recently-used partitions are evicted until the
    newcomer fits.  Sizes are predictable from plan metadata
    (``slice_nbytes`` + ``prepare.estimate``), so eviction happens
    *before* allocation: residency never transiently overshoots the
    budget.  With a budget covering every partition the loader converges
    to zero reloads; with a tight one it streams.

    ``prepare``: optional object with ``estimate(part) -> int``,
    ``build(resident) -> (inputs, nbytes)`` (on the calling thread),
    ``stage(resident) -> (inputs, nbytes, token)`` (on the prefetch
    worker) and ``adopt(inputs, token)`` (on the caller, before the
    staged inputs are used: on CUDA it waits for the worker's copies).

    ``prefetch=True`` enables the one-slot background stage:
    ``prefetch(k, prepare, keep=...)`` reserves the staged bytes a priori
    and builds window + inputs on a worker thread; the matching
    ``load(k)`` joins the future instead of paying the load.
    ``spillers`` is a list of ``spill(nbytes) -> freed`` hooks (e.g.
    :meth:`HaloLabelCache.spill`) tried after LRU eviction when a load
    still does not fit: windows always win over caches.  ``scope``:
    optional registry scope mirroring the counters.
    """

    def __init__(self, source, plan: PartitionPlan, ledger: MemoryLedger,
                 prefetch: bool = False, scope=None):
        self.source = source
        self.plan = plan
        self.ledger = ledger
        self._resident: OrderedDict[int, ResidentPartition] = OrderedDict()
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="slice-prefetch")
                      if prefetch else None)
        self._staged: dict[int, tuple[Future, int, object]] = {}
        self.spillers: list = []
        self.loads = 0          # partition loads actually performed
        self.requests = 0       # load() calls (hits + misses)
        self.prefetches = 0     # prefetches staged on the worker
        self.prefetch_hits = 0  # loads served by joining a staged future
        self._m_loads = scope.counter("loads") if scope else None
        self._m_requests = scope.counter("requests") if scope else None
        self._m_prefetches = scope.counter("prefetches") if scope else None
        self._m_pf_hits = scope.counter("prefetch_hits") if scope else None

    def load(self, index: int, prepare=None) -> ResidentPartition:
        self.requests += 1
        if self._m_requests is not None:
            self._m_requests.inc()
        res = self._resident.get(index)
        if res is None and index in self._staged:
            res = self._adopt_staged(index)
        if res is None:
            part = self.plan.parts[index]
            incoming = slice_nbytes(part)
            if prepare is not None:
                incoming += prepare.estimate(part)
            self._fit(incoming, keep=None)
            res = load_partition(self.source, part)
            self.ledger.acquire(res.nbytes, f"partition {index}")
            self._resident[index] = res
            self.loads += 1
            if self._m_loads is not None:
                self._m_loads.inc()
        else:
            self._resident.move_to_end(index)
        if prepare is not None and res.inputs is None:
            self._fit(prepare.estimate(res.part), keep=index)
            inputs, nbytes = prepare.build(res)
            self.ledger.acquire(nbytes, f"partition {index} inputs")
            res.inputs, res.inputs_nbytes = inputs, nbytes
        return res

    def prefetch(self, index: int, prepare=None,
                 keep: int | None = None) -> bool:
        """Stage partition ``index`` on the worker thread.

        Reserves the a-priori byte estimate (window + prepared inputs) in
        the ledger *before* the thread starts, evicting LRU residents
        other than ``keep`` (the partition sweeping now) to make room.
        Returns False, skipping the prefetch and never the budget, when
        the staged bytes cannot fit.
        """
        if (self._pool is None or index in self._resident
                or index in self._staged):
            return False
        part = self.plan.parts[index]
        incoming = slice_nbytes(part)
        if prepare is not None:
            incoming += prepare.estimate(part)
        if self.ledger.budget is not None:
            while self.ledger.current + incoming > self.ledger.budget:
                victim = next((i for i in self._resident if i != keep),
                              None)
                if victim is None:
                    if not self._spill(incoming):
                        return False
                    break
                self.evict(victim)
            if self.ledger.current + incoming > self.ledger.budget:
                return False
        self.ledger.acquire(incoming, f"partition {index} prefetch")

        def work():
            res = load_partition(self.source, part)
            token = None
            if prepare is not None:
                res.inputs, res.inputs_nbytes, token = prepare.stage(res)
            return res, token

        self._staged[index] = (self._pool.submit(work), incoming, prepare)
        self.prefetches += 1
        if self._m_prefetches is not None:
            self._m_prefetches.inc()
        return True

    def _adopt_staged(self, index: int) -> ResidentPartition:
        """Join a staged future and reconcile its reservation."""
        fut, reserved, prepare = self._staged.pop(index)
        try:
            res, token = fut.result()
        except BaseException:
            self.ledger.release(reserved)
            raise
        if prepare is not None:
            prepare.adopt(res.inputs, token)
        actual = res.nbytes + res.inputs_nbytes
        if actual > reserved:
            self._fit(actual - reserved, keep=index)
            self.ledger.acquire(actual - reserved,
                                f"partition {index} staged excess")
        elif actual < reserved:
            self.ledger.release(reserved - actual)
        self._resident[index] = res
        self.loads += 1
        self.prefetch_hits += 1
        if self._m_loads is not None:
            self._m_loads.inc()
            self._m_pf_hits.inc()
        return res

    def _drop_staged(self, index: int) -> None:
        fut, reserved, _prepare = self._staged.pop(index)
        try:
            fut.result()
        finally:
            self.ledger.release(reserved)

    def _fit(self, incoming: int, keep: int | None) -> None:
        """Evict LRU residents until ``incoming`` more bytes fit."""
        if self.ledger.budget is None:
            return
        while self.ledger.current + incoming > self.ledger.budget:
            victim = next((i for i in self._resident if i != keep), None)
            if victim is not None:
                self.evict(victim)
                continue
            staged = next((i for i in self._staged if i != keep), None)
            if staged is not None:
                self._drop_staged(staged)
                continue
            # caches spill last; if nothing is left the ledger raises
            self._spill(incoming)
            break

    def _spill(self, incoming: int) -> bool:
        """Ask registered caches to free room; True once it fits."""
        if self.ledger.budget is None:
            return True
        for spill in self.spillers:
            need = self.ledger.current + incoming - self.ledger.budget
            if need <= 0:
                return True
            spill(need)
        return self.ledger.current + incoming <= self.ledger.budget

    def evict(self, index: int) -> None:
        res = self._resident.pop(index, None)
        if res is not None:
            self.ledger.release(res.nbytes + res.inputs_nbytes)

    def clear(self) -> None:
        """Join and release every staged window, evict every resident one
        and stop the worker."""
        try:
            for index in list(self._staged):
                self._drop_staged(index)
        finally:
            for index in list(self._resident):
                self.evict(index)
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


class HaloLabelCache:
    """Per-partition label views on the device, keyed by partition id.

    ``gather(index, local_ids, arr)`` returns the padded local view a plain
    gather would build (owned rows, then halo imports, zero-padded to
    ``n_loc``) as a tensor on ``device``, and keeps it there between
    visits.  A per-vertex epoch array records when each vertex last changed
    (``advance(changed)`` after every assembled sweep); on a re-visit only
    the stale entries are uploaded and written into the cached view with
    ``index_copy_``.  One instance caches one global array (labels during
    propagation; the frozen community assignment and the split labels
    get their own instances, so epochs never mix).

    Entries are ledger-charged (``n_loc`` * 4 B each) and spill LRU-first
    via :meth:`spill`, registered on ``SliceLoader.spillers`` so window
    loads always win the budget.  When an entry cannot fit, ``gather``
    returns None and the caller does the plain host gather: the budget
    rule, not a device fallback.
    """

    def __init__(self, ledger: MemoryLedger, n: int, n_loc: int,
                 what: str = "labels", device="cpu"):
        self.ledger = ledger
        self.n_loc = int(n_loc)
        self.what = what
        self.device = torch.device(device)
        self.epoch = 0
        self._epoch_of = np.zeros(n, dtype=np.int64)
        self._entries: OrderedDict[int, list] = OrderedDict()  # [view, epoch]
        self.nbytes = 0
        self.bytes = 0        # label bytes actually uploaded to the device
        self.bytes_saved = 0  # gather bytes skipped thanks to the cache
        self.hits = 0         # visits served without any upload

    def advance(self, changed: np.ndarray) -> None:
        """Record one assembled sweep: ``changed`` rows now carry the new
        epoch; everything else stays valid in every cached view."""
        self.epoch += 1
        self._epoch_of[changed] = self.epoch

    def gather(self, index: int, local_ids: np.ndarray, arr: np.ndarray):
        k = len(local_ids)
        entry = self._entries.get(index)
        if entry is None:
            nb = self.n_loc * 4
            if not self._make_room(nb):
                return None          # caller does the plain host gather
            self.ledger.acquire(nb, f"halo {self.what} cache p{index}")
            self.nbytes += nb
            out = np.zeros(self.n_loc, dtype=arr.dtype)
            out[:k] = arr[local_ids]
            entry = [to_device(out, self.device), self.epoch]
            self._entries[index] = entry
            self.bytes += k * arr.itemsize
            return entry[0]
        self._entries.move_to_end(index)
        stale = np.nonzero(self._epoch_of[local_ids] > entry[1])[0]
        if len(stale):
            entry[0].index_copy_(0, to_device(stale, self.device),
                                 to_device(arr[local_ids[stale]],
                                           self.device))
            self.bytes += len(stale) * arr.itemsize
        else:
            self.hits += 1
        self.bytes_saved += (k - len(stale)) * arr.itemsize
        entry[1] = self.epoch
        return entry[0]

    def _make_room(self, nbytes: int) -> bool:
        if self.ledger.budget is None:
            return True
        while self.ledger.current + nbytes > self.ledger.budget:
            if not self._entries:
                return False
            self._evict_one()
        return True

    def _evict_one(self) -> None:
        self._entries.popitem(last=False)
        self.ledger.release(self.n_loc * 4)
        self.nbytes -= self.n_loc * 4

    def spill(self, nbytes: int) -> int:
        """Free >= ``nbytes`` if possible (LRU-first); returns freed."""
        freed = 0
        while freed < nbytes and self._entries:
            self._evict_one()
            freed += self.n_loc * 4
        return freed

    def drop(self) -> None:
        while self._entries:
            self._evict_one()

    def stats(self) -> dict:
        return {"entries": len(self._entries), "nbytes": self.nbytes,
                "bytes": self.bytes, "bytes_saved": self.bytes_saved,
                "hits": self.hits}
