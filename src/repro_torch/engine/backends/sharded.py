"""Sharded backend: multi-device detection over ``torch.distributed``.

SPMD: every rank of the mesh calls the same ``Engine.fit`` on the same
graph; this backend runs ``core.distributed``'s steps on the rank's rows
and returns the same labels on every rank.  The steps are built once per
(shape bucket, mesh, ``exchange_every``) and kept in the engine's plan
cache (``PLAN_LOG``: ``sharded:propagate`` / ``sharded:split``); the loop
replays them for every graph of the bucket, the real vertex count riding
along.  With ``exchange_every=1`` the result equals the tile and segment
backends'; with more ranks it equals the single-rank run.  The engine
leaves the graph where the caller put it (on the host, typically), and
``prepare`` moves only the rank's rows to the device.

``EngineConfig.mesh``: a ``DeviceMesh`` (flattened over all its
dimensions), or None: the default process group when one is initialised,
else one rank with no collective.

``split="lpp"`` is rejected: the distributed split step has no pruning.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.distributed import (
    default_group,
    make_lpa_step,
    make_split_step,
    resolve_shards,
    rotate,
    shard_graph,
    unrotate,
)
from repro_torch.core.graph import Graph
from repro_torch.engine.bucketing import BucketKey, pad_active, pad_labels
from repro_torch.engine.cache import PLAN_LOG
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.registry import (
    BackendRun,
    device_sync,
    register_backend,
    to_device,
    to_host,
)


def _shard_rows(bucket_n: int, n_dev: int) -> int:
    """The reference's sharded rows of a bucket: its tile rows (a multiple
    of 8), then a multiple of ``n_dev * 8``."""
    per = n_dev * 8
    return ((((bucket_n + 7) // 8) * 8 + per - 1) // per) * per


def mesh_key(mesh) -> tuple:
    """The plan-cache identity of a mesh: the mesh and the live default
    group (None: one rank), so a plan never outlives its group."""
    return (mesh, default_group())


@register_backend("sharded")
class ShardedBackend:
    name = "sharded"
    # No batched dispatch: Engine.fit_many falls back to sequential fits.
    supports_batch = False
    # The engine leaves the graph where the caller put it: prepare moves
    # only this rank's rows to the device.
    rows_only = True

    def plan_key(self, config: EngineConfig) -> tuple:
        return (mesh_key(config.mesh),)

    def build(self, bucket: BucketKey, config: EngineConfig,
              device: torch.device):
        if config.split == "lpp":
            raise ValueError("sharded backend supports split in "
                             "('none', 'lp', 'bfs_host'); use 'lp'")
        shards = resolve_shards(config.mesh)
        rows = _shard_rows(bucket.n, shards.count)
        PLAN_LOG.record("sharded:propagate")
        step = make_lpa_step(shards, rows,
                             exchange_every=config.exchange_every,
                             device=device)
        split = None
        if config.split == "lp":
            PLAN_LOG.record("sharded:split")
            split = make_split_step(shards, rows)
        n_loc = rows // shards.count
        return SimpleNamespace(
            shards=shards, rows=rows, n_loc=n_loc, row0=shards.index * n_loc,
            device=device, step=step, split=split, tau=config.tau,
            max_iterations=config.max_iterations)

    def prepare(self, graph: Graph, bucket: BucketKey,
                config: EngineConfig):
        count = resolve_shards(config.mesh).count
        return shard_graph(graph, config.mesh, d_max=bucket.d,
                           n_rows=_shard_rows(bucket.n, count),
                           device=torch.device(config.device or "cuda"))

    def run(self, plan, inputs, n_real: int,
            init_labels: np.ndarray | None,
            init_active: np.ndarray | None = None) -> BackendRun:
        sg = inputs
        dev, rows, row0 = plan.device, plan.rows, plan.row0
        labels = to_device(np.roll(pad_labels(
            np.arange(n_real, dtype=np.int32) if init_labels is None
            else init_labels, n_real, rows), -row0), dev)
        active = (np.arange(rows) < n_real) \
            & pad_active(init_active, n_real, rows)
        active = to_device(active[row0:row0 + plan.n_loc], dev)
        threshold = int(np.float32(plan.tau) * np.float32(n_real))

        device_sync(dev)
        t0 = time.perf_counter()
        it = 0
        while it < plan.max_iterations:
            labels, active, dn = plan.step(sg.nbr, sg.nw, sg.nmask, labels,
                                           active, it, n_real)
            it += 1
            # lint: host-sync-ok — one scalar per step: the convergence test
            if int(dn) <= threshold:
                break
        device_sync(dev)
        t1 = time.perf_counter()

        sit = 0
        if plan.split is not None:
            comm = labels
            labels = rotate(torch.arange(rows, dtype=torch.int32,
                                         device=dev), row0)
            while True:
                labels, dn = plan.split(sg.nbr, sg.nmask, comm, labels)
                sit += 1
                # lint: host-sync-ok — split fixed point, one scalar a round
                if int(dn) == 0:
                    break
        device_sync(dev)
        t2 = time.perf_counter()

        labels, = to_host(unrotate(labels, row0), n_real)
        return BackendRun(labels=labels, lpa_iterations=it,
                          split_iterations=sit,
                          lpa_seconds=t1 - t0, split_seconds=t2 - t1)
