"""Atomic, keep-k checkpoints of named tensors.

The port's copy of ``repro.checkpoint.manager``, in torch and numpy, with
the same file layout, so a checkpoint written by either package loads in
the other bit for bit:

  * a checkpoint is ``<dir>/step-<step>/`` holding ``arrays.npz`` (one
    host array per leaf, named by the ``/``-joined path of dict keys and
    sequence indices, as ``jax.tree_util`` names them) and
    ``manifest.json`` (shapes, dtypes, the payload's sha256, ``extra``);
  * writes go to ``tmp-<step>`` and are renamed to ``step-<step>``, so a
    crash mid-write never leaves a visible half checkpoint;
  * ``save(..., blocking=False)`` hands the host copy to a writer thread;
  * ``keep`` retains the newest k checkpoints;
  * ``restore(..., shardings=)`` reshards leaves onto device meshes as
    ``DTensor`` s (the elastic restart);
  * ``save`` of a tree with ``DTensor`` leaves (sharded train state)
    stores the full logical arrays, as the reference's manager does: every
    rank gathers each leaf (``full_tensor()``, a collective), rank 0
    alone writes, and the ranks meet at a barrier once the files are
    there (after the write, or in ``wait()`` for ``blocking=False``).

Leaves are torch tensors, numpy arrays or scalars.  Types numpy cannot
store (bfloat16) are saved as their raw unsigned bits and viewed
back on restore, as the reference does.  Restoring matches leaves by
name, never by position: JAX flattens dict keys sorted, Python dicts keep
insertion order.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

# torch dtypes with no numpy dtype -> the integer views that carry their
# bits (torch's signed one, numpy's unsigned one, as stored).
_RAW_BITS = {torch.bfloat16: (torch.int16, np.uint16)}


def _children(node):
    """``[(key, child), ...]`` of a container, None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(type(node), "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(tree, prefix=()):
    """``(path, leaf)`` in JAX's flattening order; None is no leaf."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _walk(child, prefix + (str(key),))


def _rebuild(tree, leaf_of, prefix=()):
    """``tree`` with every leaf replaced by ``leaf_of(name, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaf_of("/".join(prefix), tree)
    out = {k: _rebuild(c, leaf_of, prefix + (str(k),)) for k, c in kids}
    if isinstance(tree, dict):
        return {k: out[k] for k in tree}
    if hasattr(type(tree), "_fields"):
        return type(tree)(*(out[f".{f}"] for f in tree._fields))
    return type(tree)(out[i] for i in range(len(tree)))


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, raw bits for dtypes numpy lacks."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _RAW_BITS:
            signed, unsigned = _RAW_BITS[t.dtype]
            return t.view(signed).numpy().view(unsigned).copy()
        return t.numpy().copy()
    v = np.array(leaf, copy=True)
    if v.dtype.kind == "V" or "bfloat16" in str(v.dtype):
        v = v.view(np.uint16 if v.dtype.itemsize == 2 else np.uint8)
    return v


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flatten_named(tree, keep: bool = True) -> dict[str, np.ndarray]:
    """Host copies of the leaves by path; a ``DTensor`` leaf as its full
    array (``full_tensor()``, a collective every rank joins).  With
    ``keep=False`` (a sharded save's ranks other than 0) each gathered
    leaf is dropped at once and nothing is copied to the host."""
    out = {}
    for path, leaf in _walk(tree):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if keep:
            out["/".join(path)] = _host(leaf)
    return out


def _restore_leaf(name: str, arr: np.ndarray, ref, device) -> torch.Tensor:
    """The stored array as a tensor of ``ref``'s raw dtype, on ``device``
    (default: ``ref``'s device)."""
    ref_t = ref if isinstance(ref, torch.Tensor) else torch.as_tensor(
        np.asarray(ref))
    if list(arr.shape) != list(ref_t.shape):
        raise ValueError(
            f"{name}: checkpoint shape {arr.shape} != {tuple(ref_t.shape)}")
    if ref_t.dtype in _RAW_BITS and arr.dtype.kind == "u" \
            and arr.dtype.itemsize == ref_t.element_size():
        # bit-exact roundtrip of a dtype numpy cannot hold
        out = torch.from_numpy(arr.view(f"i{arr.dtype.itemsize}")).view(
            ref_t.dtype)
    else:
        ref_np = torch.empty((), dtype=ref_t.dtype).numpy().dtype
        if arr.dtype != ref_np and arr.dtype.kind == "u" \
                and arr.dtype.itemsize == ref_np.itemsize:
            arr = arr.view(ref_np)
        out = torch.from_numpy(np.ascontiguousarray(arr))
    return out.to(ref_t.device if device is None else device)


def _is_sharding(node) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(node, (tuple, list)) and len(node) == 2 \
        and isinstance(node[0], DeviceMesh)


def _shardings_by_name(tree, prefix=()) -> dict:
    """``name -> (mesh, placements)`` of a shardings tree (leaves named as
    ``_walk`` names them; None leaves are left out)."""
    if tree is None:
        return {}
    if _is_sharding(tree):
        return {"/".join(prefix): tree}
    kids = _children(tree)
    if kids is None:
        raise ValueError(f"shardings leaf {'/'.join(prefix)!r} must be a "
                         f"(DeviceMesh, placements) pair or None, got "
                         f"{type(tree).__name__}")
    out = {}
    for key, child in kids:
        out.update(_shardings_by_name(child, prefix + (str(key),)))
    return out


def _distribute(tensor: torch.Tensor, mesh, placements):
    """``tensor`` (the same full value on every rank) as a DTensor on
    ``mesh``: each rank keeps its own part, with no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor.to(mesh.device_type), mesh,
                             list(placements), src_data_rank=None)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier = False   # a sharded save's ranks still to meet

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = True) -> None:
        sharded = any(_is_dtensor(leaf) for _, leaf in _walk(tree))
        writer = not sharded or torch.distributed.get_rank() == 0
        named = _flatten_named(tree, keep=writer)  # the host copy
        self.wait()                    # one write in flight at a time
        if sharded:
            self._barrier = True
            if not writer:
                if blocking:
                    self.wait()
                return
        if blocking:
            self._write(step, named, extra or {})
            self.wait()
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, named, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Until the write in flight is done (and, after a sharded save,
        until every rank has called ``wait``)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, named: dict, extra: dict) -> None:
        tmp = self.dir / f"tmp-{step}"
        final = self.dir / f"step-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "arrays": {}}
        with open(tmp / "arrays.npz", "wb") as f:
            np.savez(f, **named)
        digest = hashlib.sha256((tmp / "arrays.npz").read_bytes()).hexdigest()
        for k, v in named.items():
            manifest["arrays"][k] = {"shape": list(v.shape),
                                     "dtype": str(v.dtype)}
        manifest["sha256"] = digest
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)              # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("-", 1)[1])
                      for p in self.dir.glob("step-*") if p.is_dir())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _open(self, step: int | None, verify: bool) -> tuple[int, Path, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step-{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if verify:
            digest = hashlib.sha256((d / "arrays.npz").read_bytes()
                                    ).hexdigest()
            if digest != manifest["sha256"]:
                raise IOError(f"checkpoint step-{step} hash mismatch")
        return step, d, manifest

    def load_named(self, step: int | None = None, verify: bool = True
                   ) -> tuple[dict[str, np.ndarray], int, dict]:
        """A checkpoint's raw named host arrays, without a target tree.

        For state whose shapes only the checkpoint knows (the serving
        tier's per-tenant warm labels).  Returns ``(name -> array, step,
        extra)``, verified as :meth:`restore` verifies.
        """
        step, d, manifest = self._open(step, verify)
        with np.load(d / "arrays.npz") as data:
            named = {k: data[k] for k in data.files}
        return named, step, manifest.get("extra", {})

    def restore(self, target_tree, step: int | None = None,
                shardings=None, verify: bool = True, device=None):
        """Restore into the structure of ``target_tree``.

        Each leaf comes back as a tensor with the stored dtype (raw bits
        viewed back as the target's dtype), on its target leaf's device,
        or on ``device`` when one is given.  ``shardings`` (the elastic
        restart: same structure as the tree, every leaf a ``(DeviceMesh,
        placements)`` pair of ``torch.distributed.tensor`` placements, or
        None) reshards a leaf onto its mesh: it comes back as a
        ``DTensor`` whose ``full_tensor()`` is the stored array.  Every
        rank of the mesh reads the file and keeps its own part, with no
        collective.  Returns ``(tree, step, extra)``.
        """
        placed = _shardings_by_name(shardings)
        step, d, manifest = self._open(step, verify)

        def leaf(name, ref):
            out = _restore_leaf(name, data[name], ref, device)
            return out if placed.get(name) is None \
                else _distribute(out, *placed[name])
        with np.load(d / "arrays.npz") as data:
            tree = _rebuild(target_tree, leaf)
        return tree, step, manifest.get("extra", {})
