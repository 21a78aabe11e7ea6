"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the ``meta``
device, as rank 0 of the production mesh's 256 or 512 ranks.

The port of ``repro.launch.dryrun``.  The reference AOT-compiles each
cell against ``ShapeDtypeStruct`` s on 512 XLA host devices; here each
cell runs once, in this process, as rank 0 of a fake world of the mesh's
size (torch's ``fake`` backend, ``launch.mesh.fake_world``): every
parameter, optimizer state, batch and cache tensor lies on the ``meta``
device in rank 0's shard (DTensors over ``meta`` locals), so nothing is
allocated and no device is touched.  The step is the port's own
(``train.steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on the ``DeviceMesh``, ``core.distributed.
make_lpa_step``), run under ``parallel.compat.cost_analysis``, and the
kernels take their ``meta`` paths (``kernels/ops.py``), which count their
work and do none.  Per cell it writes one JSON with the reference's keys:

  * ``cost_analysis``: the flat cost table (``StepTrace.cost``):
    ``flops`` = the products of rank 0's local tensors (FlopCounterMode's
    formulas) + the kernels' operations, and each kernel's calls, flops
    and bytes apart.  Reckonings from shapes, not measurements;
  * ``memory_analysis``: ``argument_size_in_bytes`` (rank 0's local bytes
    of every tensor the step is given: exact), ``output_size_in_bytes``
    (of what it returns), ``alias_size_in_bytes`` (of the outputs that
    are arguments updated in place: a donated train step's parameters
    and optimizer state, a decode step's caches) and
    ``temp_size_in_bytes`` (the peak of the bytes the step allocated and
    held at once: the peak of live bytes less the arguments; each ``meta``
    storage counted whole, as an allocation of its size);
    ``generated_code_size_in_bytes`` is 0 (nothing is compiled);
  * ``collectives``: ``collective_bytes`` of every collective the step
    issued (DTensor's and the port's own), kind, result bytes and group
    size recorded as it ran;
  * ``meta``: the reference's fields; ``lower_seconds`` the trace's
    seconds, ``compile_seconds`` 0.0 (there is no compile).

Where the port's step differs from the reference's by design, the cell
shows the port's: the train and serving steps take the full batch on
every rank and split it themselves (its bytes are arguments), and the
serving steps keep ``head_dim`` whole in the parameters
(``parallel.rules.serving_param_shardings``); ``meta``'s
``analytic_state_bytes_per_device`` stays the reference's reckoning over
the rules' shardings (``state_shardings``), which the tests hold equal.
A decode cell decodes the cache's last position (the caches' lengths
set to ``seq_len - 1``: a shape-only stand-in for a full cache).

The port runs the layer groups as a Python loop (``models.transformer.
_scan_groups``), so every group's products and collectives are recorded
and ``loop_trips_applied`` is 1; ``--unroll`` is accepted and marks the
record ``unrolled`` (and its file name), and changes no count.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all            # every cell, one mesh
  python -m repro_torch.launch.dryrun --arch graph-lpa --mesh multipod

JSON goes to ``experiments/dryrun_torch/`` (the reference's is
``experiments/dryrun/``).  A failed cell prints its traceback and the run
exits 1.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, get_config, input_specs, \
    supported_shapes
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import fake_world, make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# per-device wire bytes = result bytes x this factor of the group size S
# (ring algorithms), the reference's formulas
_WIRE = {"all-reduce": lambda s: 2.0 * (s - 1) / s,
         "all-gather": lambda s: (s - 1) / s,
         "reduce-scatter": lambda s: float(s - 1),
         "all-to-all": lambda s: (s - 1) / s,
         "collective-permute": lambda s: 1.0}


def collective_bytes(records, loop_trips: int = 1) -> dict:
    """Per-device collective traffic from the collectives a step issued:
    ``records`` holds (kind, result bytes on this rank, group size S).

    Result bytes are scaled to on-the-wire bytes per device with the
    reference's ring formulas over S:
      all-reduce       2 * size * (S-1)/S
      all-gather       result * (S-1)/S      (result = S x operand)
      reduce-scatter   result * (S-1)        (~input * (S-1)/S)
      all-to-all       size * (S-1)/S
      collective-permute  size
    and a group of one moves nothing.  ``loop_trips`` multiplies every
    record (the reference's rolled-loop correction; the port records each
    trip, so its dry run passes 1).
    """
    totals: dict[str, float] = {}
    wire: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, res_bytes, s in records:
        factor = 0.0 if s <= 1 else _WIRE[kind](s)
        totals[kind] = totals.get(kind, 0) + res_bytes * loop_trips
        wire[kind] = wire.get(kind, 0) + res_bytes * factor * loop_trips
        counts[kind] = counts.get(kind, 0) + 1
    totals["total"] = sum(totals.values())
    wire["total"] = sum(wire.values())
    return {"bytes": totals, "wire_bytes": wire, "counts": counts,
            "loop_trips_applied": loop_trips}


def _pairs(shardings, tree):
    """(sharding, tensor) of the leaves of two trees of one structure
    (dicts, named tuples; a ``Sharding`` is a leaf, a host int skipped)."""
    from repro_torch.parallel.api import Sharding
    if isinstance(tree, torch.Tensor):
        yield shardings, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(shardings[k], tree[k])
    elif isinstance(tree, tuple) and hasattr(type(tree), "_fields") \
            and not isinstance(shardings, Sharding):
        for s, t in zip(shardings, tree):
            yield from _pairs(s, t)


def _analytic_bytes_per_device(shardings, abstracts, mesh) -> int:
    """Each tensor's bytes over the product of the mesh axes its spec
    names (floor division), summed: the reference's reckoning."""
    from repro_torch.parallel.compat import axis_sizes
    sizes = axis_sizes(mesh)
    total = 0
    for sh, ab in _pairs(shardings, abstracts):
        size = ab.numel() * ab.element_size()
        nshards = 1
        for entry in sh.spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    nshards *= sizes[axis]
        total += size // max(nshards, 1)
    return total


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _local_bytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _leaves(tree))


def _with_length(caches, length: int):
    """The caches with every KV cache's length set to ``length``."""
    from repro_torch.models.attention import KVCache
    if isinstance(caches, KVCache):
        return caches._replace(length=length)
    if isinstance(caches, dict):
        return {k: _with_length(v, length) for k, v in caches.items()}
    return caches


def analytic_state_bytes(cfg, shape: str, mesh) -> int:
    """The reference's ``analytic_state_bytes_per_device`` of a cell: the
    parameters on the rules' shardings (``state_shardings``), + the
    optimizer state (train) or the decode caches (decode), each tensor's
    bytes over its shards.  The reference's caches carry each KV cache's
    length as a (groups,) int32 array, replicated, where the port keeps a
    host int: its bytes are counted as the reference counts them.
    ``mesh`` may be abstract (``parallel.compat.abstract_mesh``): no group
    is needed."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    sp = SHAPES[shape]
    rules, psh, osh, params_abs = S.state_shardings(cfg, mesh, shape)
    total = _analytic_bytes_per_device(psh, params_abs, mesh)
    if sp.step == "train":
        total += _analytic_bytes_per_device(
            osh, S.abstract_opt_state(cfg, params_abs), mesh)
    elif sp.step == "decode":
        caches = T.init_decode_caches(cfg, sp.global_batch, sp.seq_len,
                                      abstract=True)
        total += _analytic_bytes_per_device(
            S.cache_shardings(cfg, rules, sp.global_batch, sp.seq_len),
            caches, mesh)
        total += 4 * cfg.n_groups * _kv_caches(caches)
    return total


def _kv_caches(caches) -> int:
    """The KV caches in a cache tree."""
    from repro_torch.models.attention import KVCache
    if isinstance(caches, KVCache):
        return 1
    if isinstance(caches, dict):
        return sum(_kv_caches(c) for c in caches.values())
    return 0


def _lower_cell(arch: str, shape: str, mesh, unroll: bool = False,
                cfg=None, batch=None):
    """(run, arguments, meta) of one model cell: ``run()`` runs its step
    once on ``arguments``, placed on the ``meta`` device in rank 0's
    shards.  ``cfg`` replaces ``arch``'s config (a reduced one, a cut
    depth) and ``batch`` the cell's inputs (``meta`` tensors of another
    batch or length); ``unroll`` changes nothing (see the module
    docstring)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.api import shard_tree
    from repro_torch.train import steps as S
    cfg = get_config(arch) if cfg is None else cfg
    sp = SHAPES[shape]
    batch = input_specs(cfg, shape) if batch is None else batch
    meta: dict = {"params": cfg.param_count(),
                  "active_params": cfg.active_param_count(),
                  "step": sp.step, "seq_len": sp.seq_len,
                  "global_batch": sp.global_batch,
                  "analytic_state_bytes_per_device":
                      analytic_state_bytes(cfg, shape, mesh)}
    params_abs = S.state_shardings(cfg, mesh, shape)[3]
    if sp.step == "train":
        step, _rules, psh, osh = S.make_train_step(cfg, mesh, shape)
        opt_abs = S.abstract_opt_state(cfg, params_abs)
        args = (shard_tree(params_abs, psh), shard_tree(opt_abs, osh), batch)
        run = lambda: step(*args, 0)  # noqa: E731
    elif sp.step == "prefill":
        step, _rules, psh, _csh = S.make_prefill_step(cfg, mesh, shape)
        args = (shard_tree(params_abs, psh), batch)
        run = lambda: step(*args)  # noqa: E731
    else:  # decode
        step, _rules, psh, csh = S.make_decode_step(cfg, mesh, shape)
        caches_abs = _with_length(T.init_decode_caches(
            cfg, sp.global_batch, sp.seq_len, abstract=True), sp.seq_len - 1)
        args = (shard_tree(params_abs, psh), shard_tree(caches_abs, csh),
                batch)
        run = lambda: step(*args)  # noqa: E731
    return run, args, meta


def _lower_graph_cell(mesh, n: int = 1 << 26, d_max: int = 64,
                      exchange_every: int = 1):
    """The paper's own workload at pod scale: one distributed LPA step
    (``exchange_every`` iterations) on rank 0's rows."""
    from repro_torch.core.distributed import (
        graph_input_specs,
        make_lpa_step,
        resolve_shards,
    )
    shards = resolve_shards(mesh)
    n_dev = shards.count
    n_pad = ((n + n_dev * 8 - 1) // (n_dev * 8)) * (n_dev * 8)
    step = make_lpa_step(shards, n_pad, exchange_every=exchange_every,
                         device="meta")
    specs = graph_input_specs(n_pad, d_max)
    n_loc = n_pad // n_dev
    # rank 0's rows of the per-rank inputs; the replica whole
    args = tuple(torch.empty_like(specs[k][:n_loc])
                 for k in ("nbr", "nw", "nmask")) + (
        torch.empty_like(specs["labels"]),
        torch.empty_like(specs["active"][:n_loc]))
    run = lambda: step(*args, 0, n)  # noqa: E731
    meta = {"step": "graph_lpa", "n_vertices": n, "d_max": d_max,
            "n_pad": n_pad, "exchange_every": exchange_every,
            "directed_edges_modeled": n * d_max}
    return run, args, meta


def trace_cell(run, args) -> tuple:
    """Run ``run()`` under the cost table: (trace, memory_analysis)."""
    from repro_torch.parallel.compat import cost_analysis
    arg_ids = {id(_local(t).untyped_storage()) for t in _leaves(args)}
    with cost_analysis(args) as trace:
        out = run()
    outs = _leaves(out)
    seen, alias = set(), 0
    for t in outs:
        st = _local(t).untyped_storage()
        if id(st) in arg_ids and id(st) not in seen:
            seen.add(id(st))
            alias += _local(t).numel() * _local(t).element_size()
    mem = {"argument_size_in_bytes": _local_bytes(args),
           "output_size_in_bytes": _local_bytes(outs),
           "temp_size_in_bytes": trace.peak_bytes,
           "generated_code_size_in_bytes": 0,
           "alias_size_in_bytes": alias}
    return trace, mem


def _cell_file(out_dir: Path, arch: str, shape: str, mesh_kind: str,
               exchange_every: int = 1, unroll: bool = False) -> Path:
    suffix = f"_x{exchange_every}" if arch == "graph-lpa" and \
        exchange_every != 1 else ""
    if unroll and arch != "graph-lpa":
        suffix += "_unrolled"
    return out_dir / f"{arch}_{shape}_{mesh_kind}{suffix}.json"


def run_cell(arch: str, shape: str, mesh_kind: str,
             out_dir: Path = OUT_DIR, exchange_every: int = 1,
             unroll: bool = False) -> dict:
    """Trace one cell in a fake world of its mesh's ranks and write its
    JSON (see the module docstring); returns the record."""
    multi_pod = mesh_kind == "multipod"
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        if arch == "graph-lpa":
            run, args, meta = _lower_graph_cell(
                mesh, exchange_every=exchange_every)
        else:
            run, args, meta = _lower_cell(arch, shape, mesh, unroll=unroll)
        trace, mem = trace_cell(run, args)
        t_lower = time.time() - t0
    coll = collective_bytes(trace.collectives, loop_trips=1)
    cost = trace.cost()
    rec_unrolled = bool(unroll and arch != "graph-lpa")
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": n_chips,
        "meta": meta, "cost_analysis": cost, "memory_analysis": mem,
        "collectives": coll, "unrolled": rec_unrolled,
        "lower_seconds": round(t_lower, 2), "compile_seconds": 0.0,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = _cell_file(out_dir, arch, shape, mesh_kind, exchange_every,
                       unroll)
    fname.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {arch} {shape} {mesh_kind}: "
          f"flops={cost['flops']:.3e} "
          f"wire={coll['wire_bytes'].get('total', 0):.3e}B "
          f"trace={t_lower:.1f}s -> {fname.name}", flush=True)
    return rec


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch, cfg in ARCHS.items():
        for shape in supported_shapes(cfg):
            cells.append((arch, shape))
    cells.append(("graph-lpa", "graph"))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--exchange-every", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI: marks the "
                         "record unrolled; the port's trace records every "
                         "layer group either way")
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    meshes = ("pod", "multipod") if args.both_meshes else (args.mesh,)

    if args.all:
        todo = [(a, s, m) for a, s in all_cells() for m in meshes]
    else:
        if not args.arch:
            ap.error("--arch required without --all")
        shapes = ([args.shape] if args.shape else
                  (supported_shapes(get_config(args.arch))
                   if args.arch != "graph-lpa" else ["graph"]))
        todo = [(args.arch, s, m) for s in shapes for m in meshes]

    failures = []
    for arch, shape, mesh_kind in todo:
        fname = _cell_file(args.out_dir, arch, shape, mesh_kind,
                           args.exchange_every, args.unroll)
        if args.skip_existing and fname.exists():
            print(f"[dryrun] skip existing {fname.name}", flush=True)
            continue
        try:
            run_cell(arch, shape, mesh_kind, out_dir=args.out_dir,
                     exchange_every=args.exchange_every, unroll=args.unroll)
        except Exception:  # noqa: BLE001
            print(f"[dryrun] FAILED {arch} {shape} {mesh_kind}", flush=True)
            traceback.print_exc()
            failures.append((arch, shape, mesh_kind))
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}", flush=True)
        raise SystemExit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
