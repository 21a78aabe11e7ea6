"""Distributed GSL-LPA: vertex-partitioned label propagation over
``torch.distributed``.

SPMD, one process per rank: every rank runs the same loop on the same
graph and ends with the same labels.  The vertices are partitioned over
*all* dimensions of the mesh, flattened: shard ``s`` of ``W`` owns rows
``[s * n_loc, (s + 1) * n_loc)`` of the padded neighbor tiles and holds
only those rows on its device: only their slice of the CSR is moved
there, wherever the graph lies.  The label vector is replicated; each
sub-sweep computes the new labels of the local rows and refreshes the
replica with one all-gather, the only collective of the inner loop
(``4 * n_pad`` bytes per sub-sweep).  So a rank's device holds
``9 * d_max`` bytes per local row (the tiles) and ``5`` per padded row
of the whole graph (the replica and the changed mask of a sub-sweep).

  * ``exchange_every=1``: an all-gather after every sub-sweep, so the
    labels and iteration counts equal the single-device engine's.
  * ``exchange_every=k>1``: ``2k`` sub-sweeps per step, only the last one
    exchanging; the others patch the local slice of the replica and read
    stale remote labels.
  * The changed mask is never exchanged: each rank recovers it as new
    replica != old replica.

The kernels read a row's own label at ``labels[row]`` (``kernels/ref.py``),
so each rank keeps its replica *rotated* by its first row ``row0``:
replica position ``i`` holds the label of vertex ``(i + row0) mod n_pad``,
and the local tiles hold neighbor ids ``(v - row0) mod n_pad``.  The
rank's own rows then come first, and the all-gather writes every shard's
chunk straight into its rotated place.

The loop is driven from the host, one step per call, so the (labels,
active, iteration) state can be checkpointed between steps
(``checkpoint_cb``).  The steps run B1 (``ops.label_argmax``) and B2
(``ops.min_label``), unfused, on each rank's rows.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.graph import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.ref import label_hash
from repro_torch.obs.convergence import count_true

__all__ = ["Shards", "ShardedGraph", "default_group", "distributed_gsl_lpa",
           "exchange", "graph_input_specs", "make_lpa_step",
           "make_split_step", "resolve_shards", "rotate", "shard_graph",
           "unrotate"]


class Shards(NamedTuple):
    """A mesh resolved for this rank.

    ``group`` is the process group of the collectives (None: one rank, no
    collective); ``index`` is this rank's shard of ``count``; ``slots[g]``
    is the shard of the group's rank ``g``.
    """
    group: Any
    index: int
    count: int
    slots: tuple[int, ...]


def default_group():
    """The live default process group, or None when none is initialised.

    Part of the key of everything cached with a group in it (the resolved
    mesh here, the sharded backend's plans): a group destroyed and
    initialised again in the same process gives a ``DeviceMesh`` equal to
    the old one, and must not be handed the old group back.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@lru_cache(maxsize=16)
def _resolve_device_mesh(mesh, world) -> Shards:
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    if sorted(ranks) == list(range(dist.get_world_size())):
        group = world
    elif mesh.ndim == 1:
        group = mesh.get_group()
    else:
        group = mesh._flatten().get_group()
    members = dist.get_process_group_ranks(group)
    return Shards(group, ranks.index(me), len(ranks),
                  tuple(ranks.index(g) for g in members))


def resolve_shards(mesh=None) -> Shards:
    """``mesh``: a ``DeviceMesh`` (flattened over all its dimensions in
    row-major order, as the reference flattens its mesh axes), or None:
    the default process group when one is initialised, else one rank."""
    world = default_group()
    if mesh is not None:
        return _resolve_device_mesh(mesh, world)
    if world is not None:
        size = dist.get_world_size()
        return Shards(world, dist.get_rank(), size, tuple(range(size)))
    return Shards(None, 0, 1, (0,))


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """This rank's rows of the padded neighbor tiles, neighbor ids rotated
    by ``row0``."""
    n: int        # real vertex count
    n_pad: int    # padded rows: a multiple of (count * 8)
    d_max: int
    index: int    # this rank's shard
    count: int    # shards
    nbr: torch.Tensor    # (n_loc, d_max) int32, (v - row0) mod n_pad
    nw: torch.Tensor     # (n_loc, d_max) float32
    nmask: torch.Tensor  # (n_loc, d_max) bool

    @property
    def n_loc(self) -> int:
        return self.n_pad // self.count

    @property
    def row0(self) -> int:
        return self.index * self.n_loc


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def rotate(values: torch.Tensor, row0: int) -> torch.Tensor:
    """The rotated replica: position ``i`` holds ``values[(i + row0) mod
    n]``."""
    return torch.roll(values, -row0) if row0 else values.clone()


def unrotate(values: torch.Tensor, row0: int) -> torch.Tensor:
    """Inverse of :func:`rotate`."""
    return torch.roll(values, row0) if row0 else values


def _local_tiles(graph: Graph, n_pad: int, d_max: int, row0: int,
                 n_loc: int, device: torch.device):
    """(nbr, nw, nmask) of rows ``[row0, row0 + n_loc)``, each a fresh
    allocation on ``device``; as ``to_padded_neighbors`` builds them (pad
    slots point at the row itself, mask False; a row keeps its first
    ``d_max`` neighbors), neighbor ids rotated by ``row0``.  Only these
    rows' slice of the CSR moves to ``device``, wherever the graph lies."""
    lo, hi = min(row0, graph.n), min(row0 + n_loc, graph.n)
    # moved in their own dtypes, widened on the device
    ptr = graph.row_ptr[lo:hi + 1].to(device).long()
    e0, e1 = (int(x) for x in ptr[[0, -1]].tolist())
    src = graph.src[e0:e1].to(device).long() - lo
    col = torch.arange(e0, e1, device=device) - ptr[src]
    keep = col < d_max
    row, col = src[keep] + (lo - row0), col[keep]
    nbr = torch.arange(n_loc, dtype=torch.int32,
                       device=device)[:, None].repeat(1, d_max)
    nw = torch.zeros((n_loc, d_max), dtype=torch.float32, device=device)
    nmask = torch.zeros((n_loc, d_max), dtype=torch.bool, device=device)
    dst = graph.dst[e0:e1].to(device)[keep].long()
    nbr[row, col] = torch.remainder(dst - row0, n_pad).to(torch.int32)
    nw[row, col] = graph.wgt[e0:e1].to(device)[keep]
    nmask[row, col] = True
    return nbr, nw, nmask


def shard_graph(graph: Graph, mesh=None, d_max: int | None = None,
                n_rows: int | None = None, device=None) -> ShardedGraph:
    """This rank's tiles, on ``device`` (None: the graph's device).

    The graph may lie anywhere (on the host, typically): only this rank's
    rows of it are moved to ``device``.  ``mesh``: as
    :func:`resolve_shards` takes it.  The rows are padded as the
    reference pads them: the vertex count rounded up to 8, at least
    ``n_rows`` (the engine passes the bucket's rows, so a bucket's graphs
    shard alike), then up to a multiple of ``count * 8``: the shard
    boundaries decide which labels go stale under ``exchange_every > 1``.
    ``d_max`` defaults to the maximum degree.
    """
    sh = resolve_shards(mesh)
    dev = graph.device if device is None else torch.device(device)
    if d_max is None:
        deg = graph.row_ptr[1:] - graph.row_ptr[:-1]
        d_max = max(int(deg.max()) if graph.n else 1, 1)
    rows = max(_round_up(graph.n, 8), n_rows or 0)
    n_pad = _round_up(rows, sh.count * 8)
    n_loc = n_pad // sh.count
    nbr, nw, nmask = _local_tiles(graph, n_pad, d_max, sh.index * n_loc,
                                  n_loc, dev)
    return ShardedGraph(n=graph.n, n_pad=n_pad, d_max=d_max, index=sh.index,
                        count=sh.count, nbr=nbr, nw=nw, nmask=nmask)


def exchange(sh: Shards, new_local: torch.Tensor) -> torch.Tensor:
    """The rotated replica assembled from every shard's ``new_local``:
    shard ``q``'s chunk lands at ``((q - index) mod count) * n_loc``."""
    n_loc = new_local.shape[0]
    out = torch.empty(n_loc * sh.count, dtype=new_local.dtype,
                      device=new_local.device)
    if sh.group is None:
        out.copy_(new_local)
        return out
    views = [out[((q - sh.index) % sh.count) * n_loc:][:n_loc]
             for q in sh.slots]
    dist.all_gather(views, new_local, group=sh.group)
    return out


def graph_input_specs(n_pad: int, d_max: int) -> dict:
    """The LPA step's inputs on the ``meta`` device (no storage), the
    reference's global shapes and dtypes: ``nbr``, ``nw``, ``nmask``
    (n_pad, d_max), ``labels`` and ``active`` (n_pad,), ``iteration``
    and ``n_real`` (0-d int32).

    ``make_lpa_step`` takes a rank's part of them: ``nbr``, ``nw``,
    ``nmask`` and ``active`` per rank, the rank's ``n_pad / count`` rows;
    ``labels`` whole, the replica every rank holds (rotated by its first
    row); ``iteration`` and ``n_real`` as host ints.  The dry run hands
    rank 0 its rows: ``t[:n_pad // count]`` of a per-rank tensor."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return dict(nbr=spec((n_pad, d_max), torch.int32),
                nw=spec((n_pad, d_max), torch.float32),
                nmask=spec((n_pad, d_max), torch.bool),
                labels=spec((n_pad,), torch.int32),
                active=spec((n_pad,), torch.bool),
                iteration=spec((), torch.int32),
                n_real=spec((), torch.int32))


def _total(sh: Shards, count: torch.Tensor) -> torch.Tensor:
    if sh.group is not None:
        dist.all_reduce(count, group=sh.group)
    return count


def make_lpa_step(shards: Shards, n_pad: int, exchange_every: int = 1,
                  device=None):
    """The distributed LPA step of this rank.

    One call runs ``exchange_every`` semi-synchronous iterations (2 parity
    sub-sweeps each).  With ``exchange_every=1`` every sub-sweep ends in a
    label all-gather; with k > 1 only the last one does, and the others
    patch the local slice of the replica.

    ``step(nbr, nw, nmask, labels, active, iteration, n_real)`` ->
    ``(labels', active', delta_n)``: ``labels`` is the rotated replica
    (n_pad,), ``active`` the local rows' flags (n_loc,), ``iteration`` the
    step count (the hash seed of sub-sweep s is ``2k * iteration + s``),
    ``delta_n`` the changed count of the step over every rank, a 0-d
    int64 tensor.
    """
    if n_pad % shards.count:
        raise ValueError(f"{n_pad} rows do not split over {shards.count} "
                         "shards")
    dev = torch.device("cpu" if device is None else device)
    n_loc = n_pad // shards.count
    row0 = shards.index * n_loc
    local_ids = torch.arange(row0, row0 + n_loc, dtype=torch.int32,
                             device=dev)
    parity = (label_hash(local_ids, -1) & 1).bool()
    klasses = (~parity, parity)
    num_sweeps = 2 * exchange_every

    def step(nbr, nw, nmask, labels, active, iteration: int, n_real: int):
        real = local_ids < n_real
        dn = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(num_sweeps):
            cand = active & klasses[s % 2] & real
            seed = num_sweeps * iteration + s
            cur = labels[:n_loc]
            best_lab, best_w, cur_w = ops.label_argmax(nbr, nw, nmask,
                                                       labels, seed)
            adopt = cand & (best_w > cur_w.clamp_min(0.0))
            new_local = torch.where(adopt, best_lab, cur)
            changed_local = new_local != cur
            if s == num_sweeps - 1 or exchange_every == 1:
                new = exchange(shards, new_local)
                changed = new != labels
            else:
                # stale sub-sweep: patch the local slice, no collective
                new = labels.clone()
                new[:n_loc] = new_local
                changed = torch.zeros(n_pad, dtype=torch.bool, device=dev)
                changed[:n_loc] = changed_local
            labels = new
            dn += count_true(changed_local)
            # pruning: local rows sleep once processed, wake on a changed
            # neighbor
            wake = (changed[nbr] & nmask).any(dim=1)
            active = (active & ~cand) | (wake & real)
        return labels, active, _total(shards, dn)

    return step


def make_split_step(shards: Shards, n_pad: int):
    """The distributed SL-LP sweep of this rank: ``split(nbr, nmask, comm,
    labels)`` -> ``(labels', delta_n)``, ``comm`` and ``labels`` rotated
    replicas, one all-gather and one all-reduce per sweep."""
    n_loc = n_pad // shards.count

    def split(nbr, nmask, comm, labels):
        cur = labels[:n_loc]
        new_local = ops.min_label(nbr, nmask, labels, comm)
        dn = count_true(new_local != cur)
        return exchange(shards, new_local), _total(shards, dn)

    return split


def distributed_gsl_lpa(graph: Graph, mesh=None, tau: float = 0.05,
                        max_iterations: int = 20, exchange_every: int = 1,
                        checkpoint_cb=None, device=None):
    """Host-driven distributed GSL-LPA (propagation + SL-LP split) on this
    rank's shard; every rank of the mesh calls it with the same graph.

    ``mesh``: as :func:`resolve_shards` takes it.  ``max_iterations``
    counts steps (``exchange_every`` iterations each), and the stop test
    is ``delta_n <= tau * n`` in Python float.  ``checkpoint_cb(phase,
    iteration, labels)`` is called after every step (``"lpa"``) and every
    split sweep (``"split"``) with the (n_pad,) replica in vertex order,
    the complete restart point.  ``device``: where this rank computes;
    None is the current CUDA device.  The graph may lie on the host: only
    this rank's rows move to ``device``.

    Returns ``(labels (n,) int32 numpy, lpa steps, split sweeps)``.
    """
    dev = torch.device("cuda" if device is None else device)
    sh = resolve_shards(mesh)
    sg = shard_graph(graph, mesh, device=dev)
    row0 = sg.row0
    step = make_lpa_step(sh, sg.n_pad, exchange_every=exchange_every,
                         device=dev)
    ids = torch.arange(sg.n_pad, dtype=torch.int32, device=dev)
    labels = rotate(ids, row0)
    active = ids[row0:row0 + sg.n_loc] < sg.n
    it = 0
    while it < max_iterations:
        labels, active, dn = step(sg.nbr, sg.nw, sg.nmask, labels, active,
                                  it, sg.n)
        it += 1
        if checkpoint_cb is not None:
            checkpoint_cb("lpa", it, unrotate(labels, row0))
        # lint: host-sync-ok — one scalar per exchange round: the stop test
        if int(dn) <= tau * sg.n:
            break

    split = make_split_step(sh, sg.n_pad)
    comm = labels
    labels = rotate(ids, row0)
    sit = 0
    while True:
        labels, dn = split(sg.nbr, sg.nmask, comm, labels)
        sit += 1
        if checkpoint_cb is not None:
            checkpoint_cb("split", sit, unrotate(labels, row0))
        # lint: host-sync-ok — split fixed point, one scalar a round
        if int(dn) == 0:
            break
    out = unrotate(labels, row0)[: sg.n].cpu().numpy()
    return out, it, sit
