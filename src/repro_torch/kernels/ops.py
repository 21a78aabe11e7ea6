"""Public wrappers of the hand-written kernels, dispatched by the tensors'
device: the four LPA kernels, flash attention (B5) and its backward
(B5-bwd).

* A CUDA tensor launches the hand-written kernel from ``csrc/`` on the
  current stream (built at first use, see ``build.py``).  A kernel that
  fails to build or launch raises; nothing falls back.
* A CPU tensor takes the kernel's plain PyTorch version (``ref.py``).

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and, where it launches its kernel, adds one to
``LAUNCHES[name]``.  The neighbor vectors (``labels``, ``comm``, ``chg``) are
gathered through ``nbr`` inside the kernels; they may be longer than the
tile's row count, and ``nbr`` must index into them.

``flash_attention`` is differentiable.  On the CPU autograd goes through
its plain version.  On CUDA, when grad mode is on and q, k or v requires
grad, the call is a ``torch.autograd.Function``: its forward launches B5
with the per-row log-sum-exp (``lse``) and saves q, k, v, the output and
``lse``; its backward launches B5-bwd (``flash_attention_bwd``).  Without
grad the launch is the serving one, which writes no ``lse``.  B5 and
B5-bwd take a sliding window; B5 also takes an int8 K / V cache with its
per-(row, KV head) scales (serving only: B5-bwd has none), and
``flash_attention_fwd`` returns ``lse`` beside the output for any of
them (a sequence-parallel decode combines its ranks by it).  A bf16 B5
call with one query row (a decode step's) runs the decode body
(``csrc/flash_attention_decode.cu``): blocks per (batch, KV head, span
of the visible keys), the spans cut by ``ref.decode_split`` and
combined in a fixed order through a float32 workspace allocated per
call; ``LAUNCHES["flash_decode"]`` counts those calls, each also one
``LAUNCHES["flash_attention"]``.  Every other call runs
``csrc/flash_attention.cu``.

``count_kv_rows()`` makes the B5 launches inside it also count the key
rows their blocks load (what a window or ``kv_len`` leaves out of the
reads shows there); the output is the same either way.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``, traces a step on
the ``meta`` device) takes the kernel's path with no launch: the wrapper
returns outputs of the kernel's shapes and dtypes, allocates the
scratch the launch would, does no work and calls no plain version, and
adds the kernel's work to the cost table being filled
(``parallel.compat.add_kernel_cost``), reckoned as the kernels' bounds
are: B5 and B5-bwd by their operations over the visible (query, key)
pairs only (what causality, a window or ``kv_len`` hide is not
counted), with the bytes of each input read once and each output
written once; B1-B4 by bytes per neighbour cell (``CELL_BYTES``) and
B1 / B3 by the argmax's 2 D operations per cell.  ``LAUNCHES`` does not
move.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.parallel.compat import add_kernel_cost

__all__ = ["LAUNCHES", "MAX_DEGREE", "count_kv_rows", "flash_attention",
           "flash_attention_bwd", "flash_attention_fwd", "fused_move",
           "fused_split", "label_argmax", "min_label", "reset_launches",
           "resolve_fuse"]

# Kernel launches per op since the last reset (CUDA path only).
LAUNCHES: dict[str, int] = {"label_argmax": 0, "min_label": 0,
                            "fused_move": 0, "fused_split": 0,
                            "flash_attention": 0, "flash_decode": 0,
                            "flash_attention_bwd": 0}
MAX_DEGREE = 1024  # widest tile row the kernels take (shared-memory rows)
# What the flash-attention kernel takes: element type -> its dtype code.
_ATTN_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_HEAD_DIMS = (64, 128)
# Bytes per (row, neighbour slot) cell of one sweep, the roofline model of
# benchmarks/bench_roofline.py: the separate move sweep (its wake and B1:
# chg + mask, labels + weight + mask) 11, the fused ones (labels, weight
# or comm, mask, chg) 10, B2 alone (labels, comm, mask) 9.
CELL_BYTES = {"label_argmax": 11, "fused_move": 10, "min_label": 9,
              "fused_split": 10}
# The sweeps whose argmax does 2 D operations a cell.
_ARGMAX_SWEEPS = ("label_argmax", "fused_move")
# Query rows per tile of B5-bwd's bf16 kernel (kBM in
# csrc/flash_attention_bwd.cu; a CPU test holds the two equal): the
# padding of its scratch.
_BWD_QROWS = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The B5 launches' row counts while ``count_kv_rows`` is active, else None.
_KV_ROWS: list | None = None


@contextlib.contextmanager
def count_kv_rows():
    """Count the key rows each B5 launch inside the block loads.

    Yields a list that gets one dict per launch on leaving the block:
    ``rows`` (summed over the launch's blocks, one per batch, query head
    and query tile; in the decode body one per batch, KV head and span of
    ``ref.decode_split``), ``blocks`` and ``max_rows`` (the most one
    block loads), as the kernel counted them; its shape and masks beside
    (``B``, ``H``, ``K``, ``Sq``, ``kv_len``, ``window``, ``q_offset``).
    A block loads whole KV tiles from the one that holds its oldest
    visible key (in the decode body, its span's tiles), and nothing at or
    past ``kv_len``.  CPU calls add nothing."""
    global _KV_ROWS
    outer, _KV_ROWS = _KV_ROWS, []
    got = []
    try:
        yield got
    finally:
        mine, _KV_ROWS = _KV_ROWS, outer
        for counts, shape in mine:
            rows, blocks, most = (int(x) for x in counts.tolist())
            got.append({**shape, "rows": rows, "blocks": blocks,
                        "max_rows": most})


def resolve_fuse(fuse_sweeps: str, device) -> bool:
    """Resolve ``EngineConfig.fuse_sweeps`` against the kernel dispatch.

    ``"auto"`` fuses exactly when a kernel runs, i.e. on CUDA; the plain
    CPU path stays unfused as the parity reference.
    """
    if fuse_sweeps == "off":
        return False
    if fuse_sweeps == "on":
        return True
    if fuse_sweeps != "auto":
        raise ValueError(f"fuse_sweeps must be auto/on/off, got "
                         f"{fuse_sweeps!r}")
    return torch.device(device).type == "cuda"


def _check_tile(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_vec(name: str, t: torch.Tensor, dtype: torch.dtype,
               min_len: int, device: torch.device,
               exact: bool = False) -> None:
    ok = t.dim() == 1 and (t.shape[0] == min_len if exact
                           else t.shape[0] >= min_len)
    if t.dtype != dtype or not ok or t.device != device:
        want = f"({min_len},)" if exact else f"(>= {min_len},)"
        raise ValueError(f"{name}: expected {dtype} {want} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tiles(nbr: torch.Tensor, nmask: torch.Tensor,
           nw: torch.Tensor | None = None) -> tuple[int, int, torch.device]:
    if nbr.dim() != 2 or nbr.shape[1] < 1:
        raise ValueError(f"nbr must be (rows, D) with D >= 1, got "
                         f"{tuple(nbr.shape)}")
    rows, d = nbr.shape
    dev = nbr.device
    _check_tile("nbr", nbr, torch.int32, (rows, d), dev)
    _check_tile("nmask", nmask, torch.bool, (rows, d), dev)
    if nw is not None:
        _check_tile("nw", nw, torch.float32, (rows, d), dev)
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type != "cpu" and d > MAX_DEGREE:
        raise ValueError(f"tile width {d} exceeds the kernels' "
                         f"{MAX_DEGREE}-slot rows")
    return rows, d, dev


def _check_aligned(**tiles: torch.Tensor) -> None:
    """The LPA kernels load a narrow row's nbr (and nw) as 8- or 16-byte
    vectors and its mask as one word, so each tile must start 16-byte
    aligned."""
    for name, t in tiles.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on the card")


def _seed32(seed: int) -> int:
    """A seed as the signed 32-bit value the kernels hash (bit pattern kept)."""
    return ((int(seed) + 2**31) % 2**32) - 2**31


def _meta_sweep(name: str, nbr, *outs):
    """A sweep's ``meta`` path: its cost into the table, ``outs`` back."""
    cells = nbr.numel()
    flops = 2 * nbr.shape[1] * cells if name in _ARGMAX_SWEEPS else 0
    add_kernel_cost(name, flops, CELL_BYTES[name] * cells)
    return outs if len(outs) > 1 else outs[0]


def _launch(name: str, dev: torch.device, *args,
            symbol: str | None = None) -> None:
    fn = getattr(build.load_library(), symbol or f"lpa_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc < 0:
        raise RuntimeError(f"{name}: tensor-map encode failed with CUresult "
                           f"{-rc}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1


def label_argmax(nbr, nw, nmask, labels, seed: int):
    """Best community label per tile row (see ``ref.label_argmax_ref``).

    Returns (best_label int32, best_weight float32, current_weight float32),
    each (rows,).
    """
    rows, d, dev = _tiles(nbr, nmask, nw)
    _check_vec("labels", labels, torch.int32, rows, dev)
    if dev.type == "cpu":
        return ref.label_argmax_ref(nbr, nw, nmask, labels, seed)
    best_lab = torch.empty(rows, dtype=torch.int32, device=dev)
    best_w = torch.empty(rows, dtype=torch.float32, device=dev)
    cur_w = torch.empty(rows, dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return _meta_sweep("label_argmax", nbr, best_lab, best_w, cur_w)
    _check_aligned(nbr=nbr, nw=nw, nmask=nmask)
    if rows:
        _launch("label_argmax", dev, nbr.data_ptr(), nw.data_ptr(),
                nmask.data_ptr(), labels.data_ptr(), rows, d, _seed32(seed),
                best_lab.data_ptr(), best_w.data_ptr(), cur_w.data_ptr())
    return best_lab, best_w, cur_w


def min_label(nbr, nmask, labels, comm):
    """Split sweep: min of own label and same-community neighbor labels."""
    rows, d, dev = _tiles(nbr, nmask)
    _check_vec("labels", labels, torch.int32, rows, dev)
    _check_vec("comm", comm, torch.int32, labels.shape[0], dev, exact=True)
    if dev.type == "cpu":
        return ref.min_label_ref(nbr, nmask, labels, comm)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if dev.type == "meta":
        return _meta_sweep("min_label", nbr, out)
    _check_aligned(nbr=nbr, nmask=nmask)
    if rows:
        _launch("min_label", dev, nbr.data_ptr(), nmask.data_ptr(),
                labels.data_ptr(), comm.data_ptr(), rows, d, out.data_ptr())
    return out


def fused_move(nbr, nw, nmask, labels, chg, active, cand_prev, klass, real,
               seed: int):
    """One-pass lazy wake + LPA move (see ``ref.fused_move_ref``).

    ``chg`` is the previous sub-sweep's changed mask (per vertex),
    ``cand_prev`` its candidate set (zeros on the first sub-sweep).
    Returns (new_labels int32, active_out bool), each (rows,).
    """
    rows, d, dev = _tiles(nbr, nmask, nw)
    _check_vec("labels", labels, torch.int32, rows, dev)
    _check_vec("chg", chg, torch.bool, labels.shape[0], dev, exact=True)
    for name, t in (("active", active), ("cand_prev", cand_prev),
                    ("klass", klass), ("real", real)):
        _check_vec(name, t, torch.bool, rows, dev, exact=True)
    if dev.type == "cpu":
        return ref.fused_move_ref(nbr, nw, nmask, labels, chg, active,
                                  cand_prev, klass, real, seed)
    new = torch.empty(rows, dtype=torch.int32, device=dev)
    act = torch.empty(rows, dtype=torch.bool, device=dev)
    if dev.type == "meta":
        return _meta_sweep("fused_move", nbr, new, act)
    _check_aligned(nbr=nbr, nw=nw, nmask=nmask)
    if rows:
        _launch("fused_move", dev, nbr.data_ptr(), nw.data_ptr(),
                nmask.data_ptr(), labels.data_ptr(), chg.data_ptr(),
                active.data_ptr(), cand_prev.data_ptr(), klass.data_ptr(),
                real.data_ptr(), rows, d, _seed32(seed), new.data_ptr(),
                act.data_ptr())
    return new, act


def fused_split(nbr, nmask, labels, comm, chg, prune: bool):
    """One-pass lazy split-wake + min-label.  ``chg`` is last sweep's
    changed mask (ones on the first); not read when ``prune`` is False."""
    rows, d, dev = _tiles(nbr, nmask)
    _check_vec("labels", labels, torch.int32, rows, dev)
    _check_vec("comm", comm, torch.int32, labels.shape[0], dev, exact=True)
    _check_vec("chg", chg, torch.bool, labels.shape[0], dev, exact=True)
    if dev.type == "cpu":
        return ref.fused_split_ref(nbr, nmask, labels, comm, chg, prune)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if dev.type == "meta":
        return _meta_sweep("fused_split", nbr, out)
    _check_aligned(nbr=nbr, nmask=nmask)
    if rows:
        _launch("fused_split", dev, nbr.data_ptr(), nmask.data_ptr(),
                labels.data_ptr(), comm.data_ptr(), chg.data_ptr(),
                int(bool(prune)), rows, d, out.data_ptr())
    return out


def _check_attention(q, k, v, k_scale=None, v_scale=None) -> None:
    """q (B, Sq, H, hd) and k / v (B, Skv, K, hd): one dtype B5 takes (k /
    v int8 with bf16 ``k_scale`` / ``v_scale`` (B, Skv, K, 1) when those
    are given), hd 64 or 128, H % K == 0, contiguous, on one CPU, CUDA
    or meta device."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, _sq, h, hd = q.shape
    skv, kk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, kk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Skv, K, hd) = (b, ., ., {hd}) "
                         f"alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    quant = k_scale is not None or v_scale is not None
    kv_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _ATTN_DTYPE_CODE or not (k.dtype == v.dtype
                                               == kv_dtype):
        raise ValueError(f"q must be one of {list(_ATTN_DTYPE_CODE)} and k, "
                         f"v {'int8' if quant else 'of its dtype'}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_ATTN_HEAD_DIMS}")
    if kk < 1 or h % kk or skv < 1:
        raise ValueError(f"need H % K == 0 and Skv >= 1, got H={h}, K={kk}, "
                         f"Skv={skv}")
    dev = q.device
    if not (k.device == v.device == dev) or dev.type not in ("cpu", "cuda",
                                                             "meta"):
        raise ValueError(f"q, k, v must lie on one CPU, CUDA or meta "
                         f"device, got {q.device}, {k.device}, {v.device}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None:
                raise ValueError("k_scale and v_scale come together")
            _check_tile(name, t, torch.bfloat16, (b, skv, kk, 1), dev)
            tensors.append((name, t))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _host_int(name: str, x, lo: int, hi: int | None = None) -> int:
    """``x`` as a host int in [lo, hi]; a device scalar here would cost a
    sync per launch."""
    if (isinstance(x, (bool, torch.Tensor)) or not hasattr(x, "__index__")
            or x.__index__() < lo or (hi is not None and x.__index__() > hi)):
        raise ValueError(f"{name} must be a host int in [{lo}, "
                         f"{'inf' if hi is None else hi}], got {x!r}")
    return x.__index__()


def _mask_args(q, k, kv_len, window, q_offset):
    """(kv_len, window or None, q_offset) checked: every query row must
    see at least one key."""
    skv, sq = k.shape[1], q.shape[1]
    kv_len = _host_int("kv_len", skv if kv_len is None else kv_len, 1, skv)
    q_offset = _host_int("q_offset", q_offset, 0)
    if window is not None:
        window = _host_int("window", window, 1)
        # the last row's oldest visible key must lie below kv_len
        if sq and q_offset + sq - window >= kv_len:
            raise ValueError(f"query rows {q_offset}..{q_offset + sq - 1} "
                             f"see no key under window {window} and "
                             f"kv_len {kv_len}")
    return kv_len, window, q_offset


def _key_span(sq: int, kv_len: int, causal: bool, window, q_offset: int):
    """(visible (query, key) pairs, key rows from the first visible to the
    last) of ``sq`` query rows from position ``q_offset``."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, kv_len - 1) if causal else np.full(sq, kv_len - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    pairs = int(n.sum())
    return pairs, (int(hi.max() - lo.min() + 1) if pairs else 0)


def _meta_attention(name: str, per_pair: int, q, kv, mask: dict, tensors,
                    outs) -> None:
    """B5's or B5-bwd's cost on ``meta``: ``per_pair`` operations a visible
    pair and head dim per query head; the bytes of ``tensors`` and
    ``outs`` (read or written whole), and of ``kv`` (K, V and their
    scales) over the key rows the visible keys span."""
    b, sq, h, hd = q.shape
    pairs, rows = _key_span(sq, **mask)
    kv_row = sum(t[0, 0].numel() * t.element_size() for t in kv)
    moved = sum(t.numel() * t.element_size() for t in (*tensors, *outs))
    add_kernel_cost(name, per_pair * b * h * hd * pairs,
                    moved + b * rows * kv_row)


def _decode_work(q, split) -> torch.Tensor:
    """The decode body's float32 workspace: each span's (acc[hd], m, l)
    per batch and query head, sized from host ints."""
    b, _sq, h, hd = q.shape
    return torch.empty(b * h * split.splits * (hd + 2), dtype=torch.float32,
                       device=q.device)


def _flash_launch(q, k, v, causal: bool, kv_len: int, lse=None,
                  window=None, q_offset: int = 0, k_scale=None,
                  v_scale=None):
    """One B5 launch into a new output; ``lse`` (B, H, Sq) float32, if
    given, takes each query row's log-sum-exp.  A bf16 call with one
    query row runs the decode body."""
    b, sq, h, hd = q.shape
    skv, kk = k.shape[1], k.shape[2]
    split = None
    if sq == 1 and b and q.dtype == torch.bfloat16:
        split = ref.decode_split(b, h, kk, kv_len, causal, window, q_offset)
    if q.device.type == "meta":
        if split is not None:
            _decode_work(q, split)
        out = torch.empty_like(q)
        kv = [t for t in (k, v, k_scale, v_scale) if t is not None]
        _meta_attention("flash_attention", 4, q, kv,
                        dict(kv_len=kv_len, causal=causal, window=window,
                             q_offset=q_offset),
                        [q], [out] + ([] if lse is None else [lse]))
        return out
    # TMA reads q, k and v; the scales are read element by element
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    counts = None
    if _KV_ROWS is not None and sq and b:
        counts = torch.zeros(3, dtype=torch.int64, device=q.device)
        _KV_ROWS.append((counts, {"B": b, "H": h, "K": kk, "Sq": sq,
                                  "kv_len": kv_len, "window": window,
                                  "q_offset": q_offset}))
    scales = [None if t is None else t.data_ptr()
              for t in (k_scale, v_scale)]
    if split is not None:
        work = _decode_work(q, split)
        _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), *scales,
                None if counts is None else counts.data_ptr(),
                work.data_ptr(), b, h, kk, kv_len, skv, hd,
                int(bool(causal)), window or 0, q_offset, split.splits,
                split.per_split, symbol="attn_flash_decode")
        LAUNCHES["flash_decode"] += 1
    elif sq and b:
        _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), *scales,
                None if counts is None else counts.data_ptr(), b, h, kk,
                sq, kv_len, skv, hd, int(bool(causal)), window or 0,
                q_offset, _ATTN_DTYPE_CODE[q.dtype],
                symbol="attn_flash_attention")
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, kv_len=None,
                        window=None, q_offset: int = 0, k_scale=None,
                        v_scale=None):
    """``flash_attention`` with each query row's log-sum-exp of its
    scaled, masked scores: (out, lse (B, H, Sq) float32), what
    ``flash_attention_bwd`` reads and what a sequence-parallel decode
    combines its ranks by (see ``ref.attention_lse_ref``).  Not
    differentiable itself."""
    _check_attention(q, k, v, k_scale, v_scale)
    kv_len, window, q_offset = _mask_args(q, k, kv_len, window, q_offset)
    mask = dict(window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return (ref.flash_attention_ref(q, k, v, causal, kv_len, **mask,
                                        k_scale=k_scale, v_scale=v_scale),
                ref.attention_lse_ref(q, k, causal, kv_len, **mask,
                                      k_scale=k_scale))
    b, sq, h, _hd = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _flash_launch(q, k, v, causal, kv_len, lse, **mask,
                         k_scale=k_scale, v_scale=v_scale), lse


class _FlashAttention(torch.autograd.Function):
    """B5 forward with ``lse``, B5-bwd backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal, window=window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, kv_len: int | None = None,
                    window: int | None = None, q_offset: int = 0,
                    k_scale=None, v_scale=None):
    """GQA attention of q (B, Sq, H, hd) over k/v (B, Skv, K, hd), the
    models' layout in and out (see ``ref.flash_attention_ref``).

    Query head h reads KV head ``h // (H // K)``; query row i sits at key
    position ``q_offset + i`` (a host int, default 0; a decode step's
    query at ``kv_len - 1``), keys counted from 0.  ``causal`` hides the
    keys after a row's position, ``window`` (a host int) those ``window``
    or more positions before it (the reference's sliding window; on the
    card its tiles are not read), and ``kv_len`` (a host int, default
    Skv) the keys at and past it: they are never read on the card, while
    batches stay Skv rows apart (a decode step over the first L + 1 rows
    of a cache).  Every query row must see a key.  bfloat16 or float32,
    hd 64 or 128, contiguous; k / v int8 with their bf16 (B, Skv, K, 1)
    ``k_scale`` / ``v_scale`` (an int8 cache, ``models.attention.
    quantize_kv``), dequantised in float32.  Returns (B, Sq, H, hd) in
    q's dtype.

    Differentiable: on CUDA under grad (q, k or v requiring it) the call
    runs B5 with ``lse`` and its backward B5-bwd over every key the mask
    (``causal``, ``window``) leaves; there ``kv_len < Skv``, a
    ``q_offset`` or int8 K / V raise ``ValueError``.
    """
    _check_attention(q, k, v, k_scale, v_scale)
    kv_len, window, q_offset = _mask_args(q, k, kv_len, window, q_offset)
    mask = dict(window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, kv_len, **mask,
                                       k_scale=k_scale, v_scale=v_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # CUDA, or meta (the dry run's trace of the same path)
        if kv_len < k.shape[1] or q_offset or k_scale is not None:
            raise ValueError("kv_len < Skv, a q_offset or int8 K / V under "
                             "grad: B5-bwd takes every key of a bf16 or "
                             "float32 K / V from row 0")
        return _FlashAttention.apply(q, k, v, bool(causal), window)
    return _flash_launch(q, k, v, causal, kv_len, **mask, k_scale=k_scale,
                         v_scale=v_scale)


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool,
                        window: int | None = None):
    """Gradient of ``flash_attention(q, k, v, causal, window=window)``
    (no ``kv_len``, no ``q_offset``) for the output gradient ``dout``:
    returns (dq, dk, dv) in the inputs' dtypes and shapes (see
    ``ref.flash_attention_bwd_ref``).  Under a window the kernel walks
    only the band's tiles.

    ``out`` is the forward's output and ``lse`` (B, H, Sq) float32 its
    per-row log-sum-exp, both from B5; the CPU path recomputes them and
    reads neither.  On CUDA one call is three launches of B5-bwd, counted
    once: in bf16 delta, the main pass (dK, dV and dQ's partials, added
    into a float32 workspace in a fixed order) and dQ's cast; in float32
    delta, dK / dV and dQ.  The scratch is allocated per call: in bf16
    lse * log2(e) and delta per query row, the workspace (B * H * Sq
    rounded up to 64, times hd float32) and the zeroed tickets; in float32
    delta alone.
    """
    _check_attention(q, k, v)
    _kv_len, window, _q_offset = _mask_args(q, k, None, window, 0)
    b, sq, h, hd = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if (tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal,
                                           window=window)
    _check_tile("lse", lse, torch.float32, (b, h, sq), q.device)
    meta = q.device.type == "meta"
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not meta and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if not sq:
        dk.zero_()
        dv.zero_()
        return dq, dk, dv
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        n_qt = -(-sq // _BWD_QROWS)
        rows = b * h * n_qt * _BWD_QROWS
        scratch = (torch.empty(2 * rows, **f32),
                   torch.empty(rows * hd, **f32),
                   torch.zeros(1 + b * h * n_qt, dtype=torch.int32,
                               device=q.device))
    else:
        scratch = (torch.empty(b * h * sq, **f32),)
    if meta:
        _meta_attention("flash_attention_bwd", 10, q, [k, v],
                        dict(kv_len=k.shape[1], causal=causal,
                             window=window, q_offset=0),
                        [q, out, dout, lse], [dq, dk, dv])
        return dq, dk, dv
    ptrs = [t.data_ptr() for t in scratch] + [None] * (3 - len(scratch))
    _launch("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            *ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
            k.shape[2], sq, k.shape[1], hd, int(bool(causal)), window or 0,
            _ATTN_DTYPE_CODE[q.dtype], symbol="attn_flash_attention_bwd")
    return dq, dk, dv

