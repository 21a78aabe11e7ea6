"""Degree-balanced vertex-range partition planning for out-of-core fits.

A :class:`PartitionPlan` cuts a CSR graph into P contiguous vertex ranges
whose *edge windows* are as equal as possible — the unit of residency for
the out-of-core loop (:mod:`repro_torch.partition.ooc`).  Because the
CSR edge arrays are sorted by source vertex, a contiguous vertex range
``[lo, hi)`` owns exactly the contiguous edge window
``[row_ptr[lo], row_ptr[hi])``: a partition is a pure *slice* of the
on-disk arrays, never a gather — which is what lets
:mod:`repro_torch.partition.slices` load it zero-copy off the store's
map.  Plans are numpy only and equal the JAX package's for the same
``row_ptr``.

The cut points are computed from ``row_ptr`` (i.e. the degree sequence)
alone — O(n) host memory, no edge array ever touched.  Per-partition
**halo** sets (the out-of-partition neighbors whose labels a partition
must import each sweep) do need the ``dst`` array, so
:func:`attach_halos` streams it one partition window at a time — peak
resident edge bytes during planning is a single window.

The same (range, halo) bookkeeping is what a multi-device sharded layout
needs per shard; the plan is deliberately backend-agnostic.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """One contiguous CSR slice: vertex range + edge window + halo."""
    index: int
    lo: int        # first owned vertex (inclusive)
    hi: int        # last owned vertex (exclusive)
    e_lo: int      # first edge of the window == row_ptr[lo]
    e_hi: int      # one past the last edge == row_ptr[hi]
    # Sorted unique global ids of out-of-partition neighbors.  Their
    # labels are gathered into the partition's local row space each
    # sweep (the halo exchange); local rows are [owned vertices | halo].
    halo: np.ndarray | None = None

    @property
    def size(self) -> int:
        return self.hi - self.lo

    @property
    def num_edges(self) -> int:
        return self.e_hi - self.e_lo

    @property
    def halo_size(self) -> int:
        return 0 if self.halo is None else len(self.halo)

    @property
    def n_local(self) -> int:
        """Local row count: owned vertices followed by halo rows."""
        return self.size + self.halo_size

    def local_ids(self) -> np.ndarray:
        """(n_local,) global vertex id of every local row."""
        owned = np.arange(self.lo, self.hi, dtype=np.int32)
        if self.halo is None or not len(self.halo):
            return owned
        return np.concatenate([owned, self.halo.astype(np.int32)])


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """P contiguous CSR slices covering ``[0, n)`` / ``[0, num_edges)``."""
    n: int
    num_edges: int
    d_max: int                     # max degree (from row_ptr — plan input)
    parts: tuple[Partition, ...]

    @property
    def num_partitions(self) -> int:
        return len(self.parts)

    @property
    def max_part_size(self) -> int:
        return max(p.size for p in self.parts)

    @property
    def max_part_edges(self) -> int:
        return max(p.num_edges for p in self.parts)

    @property
    def max_n_local(self) -> int:
        return max(p.n_local for p in self.parts)

    @property
    def halo_vertices(self) -> int:
        """Total halo rows across partitions (label-exchange volume)."""
        return sum(p.halo_size for p in self.parts)

    def stats(self) -> dict:
        edges = [p.num_edges for p in self.parts]
        return {
            "partitions": self.num_partitions,
            "n": self.n, "edges": self.num_edges, "d_max": self.d_max,
            "edges_per_partition_max": max(edges),
            "edges_per_partition_min": min(edges),
            "halo_vertices": self.halo_vertices,
            "halo_fraction": self.halo_vertices / max(self.n, 1),
        }


def plan_partitions(row_ptr: np.ndarray, *,
                    max_edges: int | None = None,
                    max_vertices: int | None = None,
                    num_partitions: int | None = None) -> PartitionPlan:
    """Cut ``[0, n)`` into degree-balanced contiguous vertex ranges.

    Exactly one of ``max_edges`` / ``num_partitions`` sizes the plan;
    ``max_vertices`` optionally caps the rows per partition on top (the
    tile backend's dense-tile residency is row-proportional).  Balancing
    targets ``ceil(num_edges / P)`` edges per partition, found by binary
    search on the cumulative degree sequence (``row_ptr`` itself), so a
    partition never splits a vertex's row: a vertex whose degree alone
    exceeds the target still lands in one partition, just an oversized
    one (the budget assertion downstream catches it if it cannot fit).
    """
    row_ptr = np.asarray(row_ptr)
    n = len(row_ptr) - 1
    num_edges = int(row_ptr[-1])
    if n < 1:
        raise ValueError("cannot partition an empty vertex set")
    if (max_edges is None) == (num_partitions is None):
        raise ValueError("pass exactly one of max_edges / num_partitions")
    if max_edges is not None:
        if max_edges < 1:
            raise ValueError("max_edges must be >= 1")
        num_partitions = max(-(-num_edges // max_edges), 1)
    num_partitions = min(max(int(num_partitions), 1), n)
    target = -(-max(num_edges, 1) // num_partitions)

    degrees = row_ptr[1:] - row_ptr[:-1]
    d_max = int(degrees.max()) if n else 1

    cuts = [0]
    while cuts[-1] < n:
        lo = cuts[-1]
        hi = int(np.searchsorted(row_ptr, row_ptr[lo] + target, side="left"))
        hi = max(hi, lo + 1)           # always advance at least one vertex
        if max_vertices is not None:
            hi = min(hi, lo + max_vertices)
        cuts.append(min(hi, n))
    parts = tuple(
        Partition(index=i, lo=lo, hi=hi,
                  e_lo=int(row_ptr[lo]), e_hi=int(row_ptr[hi]))
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])))
    return PartitionPlan(n=n, num_edges=num_edges, d_max=max(d_max, 1),
                         parts=parts)


def halo_of(part: Partition, dst_window: np.ndarray) -> np.ndarray:
    """Sorted unique out-of-partition neighbor ids of one edge window."""
    dst_window = np.asarray(dst_window)
    outside = dst_window[(dst_window < part.lo) | (dst_window >= part.hi)]
    return np.unique(outside).astype(np.int32)


def attach_halos(plan: PartitionPlan, dst_reader) -> PartitionPlan:
    """Compute every partition's halo set, one edge window at a time.

    ``dst_reader(e_lo, e_hi)`` must return that window of the global
    ``dst`` array (e.g. a zero-copy store slice).  Windows are consumed
    sequentially and released before the next is read, so planning peaks
    at a single partition's edge bytes.
    """
    parts = tuple(
        dataclasses.replace(p, halo=halo_of(p, dst_reader(p.e_lo, p.e_hi)))
        for p in plan.parts)
    return dataclasses.replace(plan, parts=parts)


_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([KMGT]?I?B?)\s*$", re.I)
_SIZE_UNITS = {"": 1, "B": 1,
               "K": 10 ** 3, "KB": 10 ** 3, "KI": 2 ** 10, "KIB": 2 ** 10,
               "M": 10 ** 6, "MB": 10 ** 6, "MI": 2 ** 20, "MIB": 2 ** 20,
               "G": 10 ** 9, "GB": 10 ** 9, "GI": 2 ** 30, "GIB": 2 ** 30,
               "T": 10 ** 12, "TB": 10 ** 12, "TI": 2 ** 40, "TIB": 2 ** 40}


def parse_bytes(text) -> int:
    """``"64MB"`` / ``"1GiB"`` / ``65536`` -> bytes (int)."""
    if isinstance(text, (int, np.integer)):
        return int(text)
    m = _SIZE_RE.match(str(text))
    unit = _SIZE_UNITS.get(m.group(2).upper()) if m else None
    if unit is None:
        raise ValueError(f"cannot parse byte size {text!r} "
                         "(expected e.g. 64MB, 1GiB, 65536)")
    return int(float(m.group(1)) * unit)
