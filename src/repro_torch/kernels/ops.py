"""Public wrappers of the hand-written kernels, dispatched by the tensors'
device: the four LPA kernels and flash attention.

* A CUDA tensor launches the hand-written kernel from ``csrc/`` on the
  current stream (built at first use, see ``build.py``).  A kernel that
  fails to build or launch raises; nothing falls back.
* A CPU tensor takes the kernel's plain PyTorch version (``ref.py``).

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and, where it launches its kernel, adds one to
``LAUNCHES[name]``.  The neighbor vectors (``labels``, ``comm``, ``chg``) are
gathered through ``nbr`` inside the kernels; they may be longer than the
tile's row count, and ``nbr`` must index into them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

__all__ = ["LAUNCHES", "MAX_DEGREE", "flash_attention", "fused_move",
           "fused_split", "label_argmax", "min_label", "reset_launches",
           "resolve_fuse"]

# Kernel launches per op since the last reset (CUDA path only).
LAUNCHES: dict[str, int] = {"label_argmax": 0, "min_label": 0,
                            "fused_move": 0, "fused_split": 0,
                            "flash_attention": 0}
MAX_DEGREE = 1024  # widest tile row the kernels take (shared-memory rows)
# What the flash-attention kernel takes: element type -> its dtype code.
_ATTN_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and d > MAX_DEGREE:
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
    _check_aligned(nbr=nbr, nw=nw, nmask=nmask)
    best_lab = torch.empty(rows, dtype=torch.int32, device=dev)
    best_w = torch.empty(rows, dtype=torch.float32, device=dev)
    cur_w = torch.empty(rows, dtype=torch.float32, device=dev)
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
    _check_aligned(nbr=nbr, nmask=nmask)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
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
    _check_aligned(nbr=nbr, nw=nw, nmask=nmask)
    new = torch.empty(rows, dtype=torch.int32, device=dev)
    act = torch.empty(rows, dtype=torch.bool, device=dev)
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
    _check_aligned(nbr=nbr, nmask=nmask)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        _launch("fused_split", dev, nbr.data_ptr(), nmask.data_ptr(),
                labels.data_ptr(), comm.data_ptr(), chg.data_ptr(),
                int(bool(prune)), rows, d, out.data_ptr())
    return out


def flash_attention(q, k, v, causal: bool = True):
    """GQA attention of q (B, Sq, H, hd) over k/v (B, Skv, K, hd), the
    models' layout in and out (see ``ref.flash_attention_ref``).

    Query head h reads KV head ``h // (H // K)``; under ``causal`` query i
    sees keys 0..i, both counted from 0.  bfloat16 or float32, hd 64 or
    128, contiguous.  Returns (B, Sq, H, hd) in q's dtype.
    """
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, h, hd = q.shape
    skv, kk = k.shape[1], k.shape[2]
    dev = q.device
    if tuple(k.shape) != (b, skv, kk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Skv, K, hd) = (b, ., ., {hd}) "
                         f"alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _ATTN_DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{list(_ATTN_DTYPE_CODE)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if hd not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_ATTN_HEAD_DIMS}")
    if kk < 1 or h % kk or skv < 1:
        raise ValueError(f"need H % K == 0 and Skv >= 1, got H={h}, K={kk}, "
                         f"Skv={skv}")
    if not (k.device == v.device == dev) or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must lie on one CPU or CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if sq and b:
        _launch("flash_attention", dev, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, kk, sq, skv, hd,
                int(bool(causal)), _ATTN_DTYPE_CODE[q.dtype],
                symbol="attn_flash_attention")
    return out
