"""Meshes and the per-shard map, over ``torch.distributed``.

The port's ``repro.parallel.compat``: every mesh and every per-shard
function in the port is made here.

  * :func:`make_mesh`: a :class:`~torch.distributed.device_mesh.DeviceMesh`
    of ``shape`` with its dimensions named ``axes``
    (``init_device_mesh``), on the initialised process group;
  * :func:`abstract_mesh`: a shape-only mesh (``.shape`` maps a name to
    its size, ``.axis_names``), so the sharding rules run with no process
    group, as the reference's ``AbstractMesh`` lets them;
  * :func:`shard_map`: the counterpart of ``shard_map``, over
    ``torch.distributed.tensor.experimental.local_map``: ``f`` runs on
    each rank's local shards, and its outputs are taken as DTensors of
    the placements given;
  * :func:`axis_sizes`: ``name -> size`` of either kind of mesh;
  * :func:`mesh_sum` / :func:`mesh_max`: explicit all-reduces over mesh
    dimensions for use inside a per-shard function;
  * :func:`local_range`, :func:`write_rows`, :func:`exchange_dim` and
    :func:`lse_combine`: a rank's rows of a sharded dimension, a write of
    global rows into its shard in local terms (DTensor slice-assignment
    on a sharded dimension is not relied on), an all-to-all that makes a
    split dimension whole for the part each rank asks for (its bytes
    counted in ``EXCHANGED``), and the combine of per-rank attention
    outputs by their log-sum-exp (the sequence-parallel decode);
  * :func:`stage_gloo_all_gather`: gloo ranks on CUDA tensors stage the
    all-gather through host memory (see there).

  * :func:`cost_analysis`: the counterpart of ``cost_analysis_dict``,
    the cost table of a step traced on the ``meta`` device (the dry
    run, ``launch/dryrun.py``): the products' FLOPs, each kernel's
    FLOPs and bytes (``add_kernel_cost``, from ``kernels/ops.py``'s
    ``meta`` paths), every collective the step issued, and the peak of
    the bytes it allocated.

The reference's ``auto_axis_types`` (axis types of ``jax.make_mesh``)
has no counterpart: a ``DeviceMesh`` has no axis types.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

__all__ = ["EXCHANGED", "AbstractMesh", "StepTrace", "abstract_mesh",
           "add_kernel_cost", "add_product_flops", "axis_sizes",
           "cost_analysis", "exchange_dim", "local_range", "lse_combine",
           "lse_merge", "make_mesh", "mesh_max", "mesh_sum",
           "reset_exchanged", "shard_map", "stage_gloo_all_gather",
           "write_rows"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def abstract_mesh(shape, axes) -> AbstractMesh:
    """A shape-only mesh of ``shape`` with dimensions named ``axes``."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def axis_sizes(mesh) -> dict:
    """``name -> size`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def make_mesh(shape, axes, *, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the initialised group's ranks in
    order, its dimensions named ``axes``.  ``device_type`` defaults to
    ``"cuda"`` when a card is there and ``"cpu"`` otherwise; gloo ranks
    that share a card pass ``"cuda"``: their collectives then run over
    gloo on CUDA tensors, the all-gather staged through host memory
    (:func:`stage_gloo_all_gather`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda" and dist.get_backend() == "gloo":
        stage_gloo_all_gather()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


_STAGED: list = []


def stage_gloo_all_gather() -> None:
    """Route the functional all-gather of CUDA tensors (what DTensor's
    Shard -> Replicate and ``full_tensor`` issue) through pinned host
    memory and gloo's all-gather of host tensors, in this process.

    Under gloo, that op on CUDA tensors kills the process (SIGSEGV, torch
    2.11 on an H100) while gloo's all-reduce, reduce-scatter and
    all-to-all of CUDA tensors run; ranks that share a card must use gloo
    (NCCL refuses two ranks on one device).  A transport choice for gloo
    only: the values are the all-gather's, every other collective stays
    as it is, and NCCL's path is never touched (only gloo processes call
    this)."""
    if _STAGED:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def staged(inp, group_size, group_name):
        host = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        host.copy_(inp)
        out = torch.empty((group_size * inp.shape[0], *inp.shape[1:]),
                          dtype=inp.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, host,
                                    group=_resolve_process_group(group_name))
        return out.to(inp.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", staged, "CUDA")
    _STAGED.append(lib)


def shard_map(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """``f`` over each rank's local shards of DTensor arguments.

    ``in_specs`` / ``out_specs`` hold a placements list per argument /
    output (None for a non-tensor argument); a DTensor argument is
    redistributed to its placements first, and each output of ``f`` (a
    plain tensor) becomes a DTensor of its placements.  Autograd runs
    through: the backward of ``f`` sees local gradient shards too.
    """
    from torch.distributed.tensor.experimental import local_map
    return local_map(f, out_placements=out_specs, in_placements=in_specs,
                     in_grad_placements=in_grad_specs, device_mesh=mesh,
                     redistribute_inputs=True)


def mesh_sum(x, mesh, dims):
    """``x`` summed over the ranks of the mesh dimensions ``dims`` (one
    all-reduce each), inside a per-shard function whose ranks then use
    the sum alike: its gradient passes to each rank's ``x`` unchanged
    (every rank's part of the sum takes the sum's gradient)."""
    import torch

    class _MeshSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return _all_reduce(t.clone(), mesh, dims, "sum")

        @staticmethod
        def backward(ctx, g):
            return g

    return _MeshSum.apply(x)


def mesh_max(x, mesh, dims):
    """``x``'s elementwise max over the ranks of the mesh dimensions
    ``dims``, with no gradient."""
    return _all_reduce(x.detach().clone(), mesh, dims, "max")


def _all_reduce(t, mesh, dims, op: str):
    import torch.distributed as dist
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    for d in dims:
        dist.all_reduce(t, op=red, group=mesh.get_group(d))
    return t


def local_range(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """(offset, length) of this rank's part of tensor dimension ``dim``
    (``size`` long) under ``placements``: each mesh dimension that shards
    it splits the part before it in ``torch.chunk``'s way (ceil-sized
    chunks, in mesh-dimension order), as DTensor's ``Shard`` does."""
    lo, n = 0, size
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            k, r = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-n // k)
            start = min(r * chunk, n)
            lo, n = lo + start, min(chunk, n - start)
    return lo, n


def write_rows(dst, src, mesh, placements, dim: int, row0: int,
               size: int) -> None:
    """Global rows row0 .. row0 + n - 1 (``src``, n long on ``dim``) into
    this rank's shard ``dst`` of a tensor of ``size`` rows on ``dim``
    laid out as ``placements``: the rank writes the rows it owns, in
    local terms, and nothing else (``src`` is whole on ``dim`` and laid
    out as ``dst`` on every other dimension)."""
    lo, n = local_range(mesh, placements, dim, size)
    a, e = max(row0, lo), min(row0 + src.shape[dim], lo + n)
    if a < e:
        dst.narrow(dim, a - lo, e - a).copy_(src.narrow(dim, a - row0,
                                                        e - a))


# What :func:`exchange_dim` moved in this process: its calls and the
# bytes this rank received from other ranks (``reset_exchanged`` zeroes
# both).
EXCHANGED = {"calls": 0, "bytes_received": 0}


def reset_exchanged() -> None:
    EXCHANGED.update(calls=0, bytes_received=0)


def exchange_dim(parts, mesh, mesh_dim: int, dim: int):
    """An all-to-all over mesh dimension ``mesh_dim``: ``parts[s]`` (one
    tensor per rank s of it, all of one shape) goes to rank s, and what
    this rank receives, its own part included, comes back concatenated
    on ``dim`` in rank order.  With ``parts[s]`` this rank's piece of a
    dimension the ranks split, cut to what rank s asks for, each rank
    gets that dimension whole for its own ask.  Gloo ranks stage CUDA
    tensors through host memory (see :func:`stage_gloo_all_gather`)."""
    import torch
    import torch.distributed as dist
    group = mesh.get_group(mesh_dim)
    x = torch.stack(parts)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if host else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    EXCHANGED["calls"] += 1
    EXCHANGED["bytes_received"] += ((len(parts) - 1) * parts[0].numel()
                                    * parts[0].element_size())
    return torch.cat(out.unbind(0), dim=dim).to(x.device)


def lse_combine(out, lse, mesh, dims):
    """Per-rank attention outputs ``out`` (B, Sq, H, hd) over disjoint key
    sets, each with its rows' log-sum-exp ``lse`` (B, H, Sq) float32 (-inf
    for a rank that saw no key), combined into the attention over their
    union on every rank of mesh dimensions ``dims``: sum_r e^(lse_r - M)
    out_r / sum_r e^(lse_r - M), M the largest lse_r.  In ``out``'s
    dtype; float32 in between."""
    return lse_merge(out, lse,
                     lambda t, op: _all_reduce(t, mesh, dims, op))


def lse_merge(out, lse, reduce):
    """:func:`lse_combine`'s arithmetic with the reduction given:
    ``reduce(t, "max" | "sum")`` reduces ``t`` over the parts (an
    all-reduce across ranks, or a sum over a leading dimension that
    stacks the parts)."""
    import torch
    m = reduce(lse.clone(), "max")
    w = torch.exp(lse - m).transpose(-1, -2)[..., None]    # (B, Sq, H, 1)
    num = reduce(out.float() * w, "sum")
    den = reduce(w.contiguous(), "sum")
    return (num / den).to(out.dtype)


# ------------------------------------------------------------ cost table

# The collectives a traced step can issue: op name -> (kind, the argument
# that holds the result, or None for the op's return value).  The
# functional ops are DTensor's (``_c10d_functional``, and its autograd
# variants); the in-place ``c10d`` ops are what ``torch.distributed``'s
# calls issue (``mesh_sum``, ``exchange_dim``, ``core.distributed.
# exchange``, ``stage_gloo_all_gather``'s staged gather).
_COLLECTIVES = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_reduce_coalesced_": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", None),
    "all_gather_into_tensor_coalesced": ("all-gather", None),
    "all_gather_into_tensor_out": ("all-gather", None),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", None),
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "output_tensors"),
    "_allgather_base_": ("all-gather", "output_tensor"),
    "allgather_into_tensor_coalesced_": ("all-gather", "outputs"),
    "reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "outputs"),
    "alltoall_": ("all-to-all", "output_tensors"),
    "alltoall_base_": ("all-to-all", "output"),
}
# Ops of those namespaces that move no data.
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd")

# The cost tables being filled, innermost last: a module global, not a
# context variable, since autograd may run a backward (B5-bwd's) on
# another thread.
_TABLES: list = []


def add_kernel_cost(name: str, flops: int, bytes_: int) -> None:
    """Add one call of kernel ``name`` (``flops`` operations, ``bytes_``
    moved: each input read once, each output written once) to the cost
    table being filled, if any (``kernels/ops.py``'s ``meta`` paths)."""
    if _TABLES:
        k = _TABLES[-1].kernels.setdefault(
            name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(bytes_)


def add_product_flops(flops: int) -> None:
    """Add ``flops`` of matrix products that a ``meta`` stand-in skipped
    (``models.rwkv._MetaScan``) to the cost table being filled, if any."""
    if _TABLES:
        _TABLES[-1].product_flops += int(flops)


def _tensors(x) -> list:
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args, kwargs) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "process_group" in named:
        return dist.ProcessGroup.unbox(named["process_group"]).size()
    return _resolve_process_group(named["group_name"]).size()


class StepTrace:
    """What a step traced under :func:`cost_analysis` did, rank 0's part
    of it (``.cost()`` is the flat table):

      * ``product_flops``: the matrix products of the rank's local
        tensors, counted by ``torch.utils.flop_counter.FlopCounterMode``'s
        formulas (a DTensor op is not counted itself: DTensor's dispatch
        issues the local ops, which are; FlopCounterMode alone would count
        a DTensor product at its global shape);
      * ``kernels``: name -> calls, flops, bytes of the hand-written
        kernels' ``meta`` paths (``add_kernel_cost``);
      * ``collectives``: (kind, result bytes on this rank, group size) of
        every collective issued, DTensor's and the explicit ones alike; a
        collective op this table does not know raises;
      * ``peak_bytes``: the most bytes of storage allocated during the
        step and alive at once (the arguments, allocated before, are not
        in it); ``live_bytes`` what is still alive.
    Ops that DTensor's sharding propagation runs on fake tensors are
    neither counted nor tracked."""

    def __init__(self) -> None:
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.product_flops = 0
        self.kernels: dict = {}
        self.collectives: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known: set = set()
        self._mode = None

    def keep(self, tensors) -> None:
        """Mark the storages of ``tensors`` as allocated before the step
        (the arguments): never counted as the step's."""
        for t in _tensors(tensors):
            for local in _locals(t):
                self._known.add(id(local.untyped_storage()))

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._known.discard(key)
        self.live_bytes -= n

    def _record(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _NOT_COLLECTIVES:
            return
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"the cost table does not know the "
                                      f"collective {func}")
        kind, where = _COLLECTIVES[name]
        if where is None:
            result = out
        else:
            named = dict(zip((a.name for a in func._schema.arguments),
                             args))
            named.update(kwargs)
            result = named[where]
        self.collectives.append((kind, _nbytes(_tensors(result)),
                                 _group_size(func, args, kwargs)))

    def dispatch(self, func, types, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in _tensors((args, kwargs, out))):
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._record(func, args, kwargs, out)
        elif func.overloadpacket in self.registry:
            self.product_flops += int(self.registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        self._track(out)
        return out

    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    def cost(self) -> dict:
        """The flat table: ``flops`` (products + kernels),
        ``product_flops``, ``kernel_flops``, and ``<kernel> calls`` /
        ``<kernel> flops`` / ``<kernel> bytes`` for each kernel called."""
        out = {"flops": float(self.product_flops + self.kernel_flops()),
               "product_flops": float(self.product_flops),
               "kernel_flops": float(self.kernel_flops())}
        for name, k in sorted(self.kernels.items()):
            for key, v in k.items():
                out[f"{name} {key}"] = float(v)
        return out


def _locals(t) -> list:
    from torch.distributed.tensor import DTensor
    return [t.to_local()] if isinstance(t, DTensor) else [t]


@contextlib.contextmanager
def cost_analysis(arguments=()):
    """Trace the step run inside the block: yields a :class:`StepTrace`
    that fills as it runs (``.cost()`` is the flat table).  The storages
    of ``arguments`` (a tree of tensors or DTensors) are the step's
    inputs, not its allocations."""
    from torch.utils._python_dispatch import TorchDispatchMode
    trace = StepTrace()
    trace.keep(arguments)

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return trace.dispatch(func, types, args, kwargs or {})

    _TABLES.append(trace)
    try:
        with _Mode():
            yield trace
    finally:
        _TABLES.remove(trace)
