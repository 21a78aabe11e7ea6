"""Per-fit convergence profiles: the frontier-decay curve of one run.

A ``ConvergenceProfile`` holds, per sub-sweep, the candidate
(active-frontier) count, the labels-changed count and the sub-sweep
index, without adding a host read to the sweep loops:

* The loops write each row into a preallocated buffer on the fit's
  device (:func:`record_row`): the row index is a Python int, the counts
  stay device tensors.  A ``(2 * max_iterations, 3)`` buffer per solo
  phase (row ``2*it + sweep`` in propagation), ``(rows, 2, k1)`` per
  batched phase (per-slot counts as exact integer segment sums).
* The buffer comes down once, beside the labels, after the loop's last
  synchronize, and the host builds the profile here.  The writes never
  feed back into labels or the convergence test, so a profiled fit gives
  the labels and iteration counts of an unprofiled one.
* Host-side loops that already reduce per-sweep counts on the host
  record rows with :func:`phase_from_rows`.

``EngineConfig.profile`` selects the depth: ``"off"`` (no buffer; the
flag joins ``algo_key()``), ``"convergence"`` (propagation) or
``"full"`` (propagation and the Split-Last phase).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Multiplying a word of eight 0/1 bytes by this gathers their sum (at most
# 8, so no byte carries) into the top byte.
_BYTE_SUM = 0x0101010101010101


@dataclasses.dataclass
class PhaseProfile:
    """Per-sub-sweep counters for one phase of one fit."""
    phase: str            # "propagation" | "split"
    sweep: np.ndarray     # (S,) int32 sub-sweep index (2*it + parity)
    active: np.ndarray    # (S,) candidate-vertex count entering the sweep
    changed: np.ndarray   # (S,) vertices that changed label in the sweep
    truncated: bool = False  # phase outran the preallocated buffer

    @property
    def num_sub_sweeps(self) -> int:
        return int(len(self.sweep))

    def to_dict(self) -> dict:
        return {"phase": self.phase, "sweep": self.sweep.tolist(),
                "active": self.active.tolist(),
                "changed": self.changed.tolist(),
                "truncated": self.truncated}


@dataclasses.dataclass
class ConvergenceProfile:
    """Full profile of one fit: propagation always, split under "full"."""
    propagation: PhaseProfile
    split: PhaseProfile | None = None
    n: int = 0            # real vertex count (frontier fractions)

    def frontier_decay(self) -> np.ndarray:
        """Active-frontier fraction per propagation sub-sweep
        (active[t] / n)."""
        if not self.n:
            return np.zeros(0, np.float64)
        return self.propagation.active.astype(np.float64) / float(self.n)

    def to_dict(self) -> dict:
        return {"n": self.n, "propagation": self.propagation.to_dict(),
                "split": self.split.to_dict() if self.split else None}


def empty_profile_buffer(rows: int, device="cpu"):
    """Solo buffer on ``device``: (rows, 3) int32, -1 marks unwritten."""
    return torch.full((rows, 3), -1, dtype=torch.int32, device=device)


def empty_batch_profile_buffer(rows: int, k1: int, device="cpu"):
    """Batched buffer on ``device``: (rows, 2, k1) int32 [active,
    changed] per slot, -1 marks unwritten."""
    return torch.full((rows, 2, k1), -1, dtype=torch.int32, device=device)


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """Exact number of True entries of a bool tensor, as a 0-d int64
    tensor on its device (no host read).

    ``mask.sum()`` first casts the whole mask to int64, writing eight
    bytes per entry.  Here each eight bool bytes are read as one int64
    word whose byte sum a multiply gathers into the top byte, so no pass
    moves more than one byte per entry.  A mask that cannot be viewed so
    (empty, length not a multiple of 8, or unaligned) takes ``sum()``.
    """
    n = mask.numel()
    if not n or n % 8 or not mask.is_contiguous() \
            or mask.storage_offset() % 8:
        return mask.sum()
    words = mask.view(torch.int64)
    return torch.bitwise_right_shift(words * _BYTE_SUM, 56).sum()


def record_row(buf, row: int, active, changed, sweep: int) -> None:
    """Write one sweep's counts into a profile buffer, on its device.

    ``active`` / ``changed``: 0-d count tensors (a solo buffer) or (k1,)
    per-slot counts (a batched buffer); ``sweep`` fills a solo buffer's
    third column.  Copies between tensors on one device: no host read.
    """
    buf[row, 0] = active
    buf[row, 1] = changed
    if buf.dim() == 2:
        buf[row, 2] = sweep


def _host(buf) -> np.ndarray:
    return buf.cpu().numpy() if hasattr(buf, "cpu") else np.asarray(buf)


def phase_from_buffer(phase: str, buf, rows: int,
                      truncated: bool = False) -> PhaseProfile:
    """Trim a fetched (cap, 3) [active, changed, sweep] buffer to the
    ``rows`` sub-sweeps that actually ran."""
    arr = _host(buf)
    rows = max(0, min(int(rows), arr.shape[0]))
    return PhaseProfile(phase=phase,
                        sweep=arr[:rows, 2].astype(np.int32),
                        active=arr[:rows, 0].astype(np.int64),
                        changed=arr[:rows, 1].astype(np.int64),
                        truncated=truncated)


def phase_from_batch_buffer(phase: str, buf, slot: int,
                            rows: int, truncated: bool = False,
                            ) -> PhaseProfile:
    """Slice one member's curve out of a fetched (cap, 2, k1) buffer."""
    arr = _host(buf)
    rows = max(0, min(int(rows), arr.shape[0]))
    return PhaseProfile(phase=phase,
                        sweep=np.arange(rows, dtype=np.int32),
                        active=arr[:rows, 0, slot].astype(np.int64),
                        changed=arr[:rows, 1, slot].astype(np.int64),
                        truncated=truncated)


def solo_profile(pbuf, lpa_iters: int, sbuf, split_iters: int,
                 split_cap: int, n: int) -> ConvergenceProfile:
    """Assemble a solo fit's profile from fetched buffers.

    ``pbuf``: propagation (cap, 3) buffer, valid rows = ``2 * lpa_iters``.
    ``sbuf``: optional split buffer capped at ``split_cap`` sweeps — a
    split that outran the cap overwrote the last row (flagged truncated).
    """
    prop = phase_from_buffer("propagation", pbuf, 2 * lpa_iters)
    split = None
    if sbuf is not None:
        split = phase_from_buffer("split", sbuf,
                                  min(split_iters, split_cap),
                                  truncated=split_iters > split_cap)
    return ConvergenceProfile(propagation=prop, split=split, n=n)


def batch_profiles(pbuf, lpa_iters, sbuf, split_iters, split_cap: int,
                   sizes) -> list[ConvergenceProfile]:
    """Per-slot profiles from a batched run's fetched (cap, 2, k1)
    buffers.  Each slot's curve is trimmed to the sub-sweeps *its* solo
    run would have executed (frozen slots stop counting)."""
    pb = _host(pbuf)
    sb = None if sbuf is None else _host(sbuf)
    lpa_iters = np.asarray(lpa_iters)
    split_iters = None if split_iters is None else np.asarray(split_iters)
    out = []
    for i, n_i in enumerate(np.asarray(sizes)):
        prop = phase_from_batch_buffer("propagation", pb, i,
                                       2 * int(lpa_iters[i]))
        split = None
        if sb is not None:
            si = int(split_iters[i])
            split = phase_from_batch_buffer("split", sb, i,
                                            min(si, split_cap),
                                            truncated=si > split_cap)
        out.append(ConvergenceProfile(propagation=prop, split=split,
                                      n=int(n_i)))
    return out


def phase_from_rows(phase: str, rows: list[tuple[int, int, int]],
                    ) -> PhaseProfile:
    """Host-side accumulation: a list of (sweep_index, active_count,
    changed_count) rows."""
    arr = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
    return PhaseProfile(phase=phase, sweep=arr[:, 0].astype(np.int32),
                        active=arr[:, 1], changed=arr[:, 2])
