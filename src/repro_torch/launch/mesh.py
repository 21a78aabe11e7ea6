"""Device meshes over ``torch.distributed``, and a launcher of ranks.

The port runs multi-device detection SPMD: one process per rank, every
rank calling the same ``Engine(...).fit(graph)`` (``engine/backends/
sharded.py``).  A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
on an initialised process group; the sharded backend flattens it over all
its dimensions.

  * :func:`make_flat_mesh`: one dimension over every rank of the world,
    the engine's sharded default;
  * :func:`make_host_mesh`: an N-D mesh (small meshes for CPU tests);
  * :func:`spawn_ranks`: starts ``world_size`` ranks, each in a process
    group rendezvoused through a ``file://`` store in a temporary
    directory (no TCP port to pick), runs a function on each and returns
    their results, with one deadline over the whole run;
  * :func:`make_production_mesh`: the reference's 16 x 16 pod, or 2 x 16
    x 16 multipod, over the live group;
  * :func:`fake_world`: a world of any size in this one process, which
    plays its rank 0 over torch's ``fake`` backend (every collective
    returns at once and moves nothing): what the dry run traces a cell
    in.

Importing this module starts nothing and touches no device.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["fake_world", "make_flat_mesh", "make_host_mesh",
           "make_production_mesh", "spawn_ranks"]


def make_host_mesh(shape=(4, 2), axes=("data", "model")):
    """An N-D mesh of ``shape`` over the initialised group's ranks in
    order, its dimensions named ``axes``; on CUDA under NCCL, else on the
    CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_flat_mesh(axis: str = "data"):
    """One dimension over every rank of the world."""
    return make_host_mesh((dist.get_world_size(),), (axis,))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the live group's 256 (or,
    ``multi_pod``, 512) ranks: (16, 16) ``("data", "model")``, or (2, 16,
    16) ``("pod", "data", "model")``; on the CPU unless the group is
    NCCL's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes)


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``world_size``-rank process group on
    torch's ``fake`` backend (``torch.testing._internal.distributed.
    fake_pg``): meshes, DTensors and collectives work as on a real group,
    but no rank exists beside this one and a collective returns at once
    with its output as it was.  Destroyed on leaving the block.  For
    shape-only work (the dry run's ``meta`` tensors)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn, world_size: int, args: tuple, backend: str,
               timeout: float, tmp: str) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world_size, timeout=timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".part", path)


def spawn_ranks(fn, world_size: int, args: tuple = (), *,
                backend: str = "gloo", timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned
    processes and return their return values in rank order.

    Each rank joins a ``backend`` process group (``"gloo"`` or
    ``"nccl"``; under NCCL rank r takes card ``r % device_count``) whose
    collectives time out after ``timeout`` seconds, and destroys it when
    ``fn`` ends.  ``fn`` must be importable from the child (a module-level
    function).  A rank that raises, or the run outlasting ``timeout``
    seconds, stops every rank and raises here.
    """
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    ctx = None
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, tuple(args), backend, timeout,
                              tmp),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not finish "
                                   f"within {timeout} s")
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
