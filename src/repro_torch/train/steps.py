"""Train / prefill / decode step builders, on one device or a mesh.

The port of ``repro.train.steps``.  Each builder returns the reference's
tuple, ``(step function, rules, param shardings, state shardings)``.

With ``mesh=None`` (or a mesh-like object of one device that is not a
``DeviceMesh``) the step runs on one device on plain tensors, and the
three sharding entries are None.  With a ``DeviceMesh`` (``data`` and
``model`` axes, and ``pod`` where given; ``parallel.make_mesh``) the
train step is the reference's sharded step, one process per rank:

  * parameters are DTensors placed by the sharding rules
    (``state_shardings``: TP over ``model`` for heads, ff and vocab);
    ``shard_tree`` (``parallel.api``) places a tree that every rank
    holds in full;
  * the batch is split over the data axes (``batch_shardings``), from
    the full batch every rank is given;
  * the loss and the gradients come from autograd on DTensors under the
    rules (``use_rules``): every attention call runs on the rank's own
    heads (B5 / B5-bwd on the card, ``models.attention``), the MoE
    dispatches per data shard;
  * the gradients are redistributed onto the ZeRO-1 shardings (the
    reduce-scatter); ``optim.adamw_update`` then takes the norm of the
    whole gradient, runs AdamW on each rank's 1/DP of the state, and
    redistributes the parameters back to their shardings (the
    all-gather).  One step function serves both cases: on a mesh it
    places the batch, moves the gradients and runs under the rules.

``make_prefill_step`` and ``make_decode_step`` run on one device with
``mesh=None`` or a mesh of one device, and return ``(fn, None, None,
None)``.  On a ``DeviceMesh`` of more than one device they are the
reference's sharded serving steps, ``(fn, rules, psh, csh)``: the
parameters are DTensors on ``psh`` (``shard_tree``; the rules'
shardings with ``head_dim`` whole, ``parallel.rules.
serving_param_shardings``), the batch is the
full batch on every rank (split over the data axes where the cell's
global batch divides them), and the caches are DTensors on ``csh``, the
rules' shardings of ``parallel.rules.cache_logical_axes``: KV heads over
``model`` (or ``head_dim`` where the KV heads do not divide it) and the
batch over the data axes, or the rows over the data axes for a batch
that does not divide them (the sequence-parallel cache).  Prefill makes
its caches there; decode writes them in place, each rank its own shard
(``models.attention`` runs B5 per rank in each layout).  The logits
come back whole on every rank; ``gather_tree`` gathers a cache tree.

Train step semantics (the reference's):
  * the loss in float32, parameters and gradients in the parameters'
    dtype (bf16 for the configs); gradients from autograd;
  * optional microbatch gradient accumulation: a float32 accumulator,
    each microbatch's gradient divided by k and added, cast back to the
    parameters' dtype; the loss is the microbatches' mean (on a mesh each
    microbatch's gradient is reduce-scattered before it is added);
  * remat comes from the arch config (``models.transformer``'s groups);
  * AdamW (``optim.adamw_update``) with the cosine lr.  ``donate``
    updates the parameters and the optimizer state in place (the
    reference donates their buffers to XLA), so a step holds one copy of
    each.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.optim.adamw import (
    _redistribute,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.parallel.api import gather_tree, shard_tree

__all__ = ["abstract_opt_state", "batch_shardings", "cache_shardings",
           "gather_tree", "init_opt_state", "make_decode_step",
           "make_prefill_step", "make_train_step", "shard_tree",
           "state_shardings"]


def _mesh_size(mesh) -> int:
    size = mesh.size
    return size() if callable(size) else size


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _serving_mesh(mesh) -> bool:
    """True for a ``DeviceMesh`` of more than one device (the sharded
    steps); False for None or one device; a larger mesh of another kind
    raises."""
    if mesh is None or _mesh_size(mesh) == 1:
        return False
    if not _is_device_mesh(mesh):
        raise ValueError("a mesh of more than one device must be a "
                         "DeviceMesh (parallel.make_mesh)")
    return True


def cache_shardings(cfg: ArchConfig, rules, batch: int, s_max: int):
    """The rules' shardings of the decode caches of ``batch`` x ``s_max``
    (``init_decode_caches``' tree; a ``KVCache``'s length stays an int)."""
    from repro_torch.parallel.rules import cache_logical_axes
    caches = T.init_decode_caches(cfg, batch, s_max, abstract=True)

    def rec(ax):
        if isinstance(ax, dict):
            return {k: rec(v) for k, v in ax.items()}
        if isinstance(ax, tuple) and hasattr(type(ax), "_fields"):
            return type(ax)(*(rec(v) for v in ax))
        if isinstance(ax, tuple):
            return rules.sharding(ax)
        return ax
    return rec(cache_logical_axes(cfg, caches))


def state_shardings(cfg: ArchConfig, mesh, shape: str):
    """(rules, param shardings, optimizer-state shardings, abstract params
    on the ``meta`` device).  The state's ``m`` and ``v`` take the ZeRO-1
    shardings, its ``count`` is replicated."""
    from repro_torch.models.common import abstract_from_specs, logical_axes
    from repro_torch.parallel import (
        Sharding,
        make_rules,
        param_shardings,
        zero1_shardings,
    )
    specs = T.model_specs(cfg)
    axes = logical_axes(specs)
    rules = make_rules(mesh, cfg, shape)
    psh = param_shardings(rules, axes)
    abstract = abstract_from_specs(specs)
    zsh = zero1_shardings(rules, axes, abstract)
    osh = AdamWState(m=zsh, v=zsh, count=Sharding(mesh, ()))
    return rules, psh, osh, abstract


def batch_shardings(cfg: ArchConfig, mesh, shape: str, batch_tree):
    """Batch arrays shard on the leading (batch) dim over the data axes
    when the cell's global batch divides them, else replicate."""
    from repro_torch.parallel import Sharding, data_axes
    from repro_torch.parallel.rules import dp_size
    lead = data_axes(mesh) if SHAPES[shape].global_batch % dp_size(mesh) \
        == 0 else None
    return tree_map(lambda x: Sharding(mesh, (lead,) if lead else ()),
                    batch_tree)


def _check_shape(shape: str) -> None:
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; known: {sorted(SHAPES)}")


def _state_dtype(cfg: ArchConfig) -> torch.dtype:
    return (torch.bfloat16 if cfg.optimizer_state_dtype == "bfloat16"
            else torch.float32)


def _loss_and_grads(cfg, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``; the gradients have the
    parameters' tree and dtypes."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = T.loss_fn(cfg, tracked, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tracked))
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, mesh=None, shape: str = "train_4k",
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, microbatch: int | None = None,
                    donate: bool = True, keep_grads: bool = False):
    """Returns (step, rules, psh, osh): None for the last three on one
    device.

    step(params, opt_state, batch, step_idx) ->
        (params, opt_state, {"loss", "grad_norm", "lr"})

    ``batch`` holds ``tokens`` and ``targets`` (B, S) on the parameters'
    device (and a VLM's ``vision_embeds`` / an encoder-decoder's
    ``frames``); ``step_idx`` is a host int.  ``loss`` and ``grad_norm``
    are 0-d device tensors, ``lr`` a 0-d CPU tensor.  ``shape`` names the
    cell (``configs.base.SHAPES``); one device runs whatever batch it is
    given.  ``keep_grads`` adds ``grads`` to the metrics: the gradients
    AdamW was given, in the parameters' tree (for checks against another
    device).

    On a ``DeviceMesh``, ``params`` and ``opt_state`` are DTensors on
    ``psh`` / ``osh`` (``shard_tree``, ``init_opt_state(..., osh)``) and
    ``batch`` is the full batch, the same on every rank, or DTensors;
    ``loss`` and ``grad_norm`` are plain 0-d tensors, the same on every
    rank, and ``grads`` DTensors on the ZeRO-1 shardings.
    """
    _check_shape(shape)
    rules = psh = osh = None
    place = on_grads = _identity
    context = contextlib.nullcontext
    if mesh is not None and _is_device_mesh(mesh):
        rules, psh, osh, _abstract = state_shardings(cfg, mesh, shape)
        place = functools.partial(_place_batch, cfg, mesh, shape)
        on_grads = functools.partial(_onto, shardings=osh.m)  # reduce-scatter
        context = functools.partial(_sharded_context, rules)
    elif mesh is not None and _mesh_size(mesh) != 1:
        raise ValueError("a mesh of more than one device must be a "
                         "DeviceMesh (parallel.make_mesh)")

    def grads_of(params, batch):
        loss, g = _loss_and_grads(cfg, params, place(batch))
        return loss, on_grads(g)

    def compute_grads(params, batch):
        if not (microbatch and microbatch > 1):
            return grads_of(params, batch)
        acc, losses = None, []
        parts = {k: v.reshape((microbatch, -1) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        for i in range(microbatch):
            loss, g = grads_of(params, {k: v[i] for k, v in parts.items()})
            if acc is None:
                acc = tree_map(lambda gg: torch.zeros_like(
                    gg, dtype=torch.float32), g)
            tree_map(lambda a, gg: a.add_(gg.to(torch.float32) / microbatch),
                     acc, g)
            losses.append(loss)
        return torch.mean(torch.stack(losses)), tree_map(
            lambda a, p: a.to(p.dtype), acc, params)

    def step_fn(params, opt_state, batch, step_idx):
        with context():
            loss, grads = compute_grads(params, batch)
            lr = cosine_schedule(step_idx, peak_lr=peak_lr,
                                 warmup_steps=warmup,
                                 total_steps=total_steps)
            new_params, new_opt, metrics = adamw_update(
                grads, opt_state, params, float(lr), in_place=donate)
        metrics.update(loss=loss, lr=lr)
        if keep_grads:
            metrics["grads"] = grads
        return new_params, new_opt, metrics

    return step_fn, rules, psh, osh


def _identity(x):
    return x


def _place_batch(cfg, mesh, shape, batch):
    """The full batch (plain tensors or DTensors) split over the data axes
    (``batch_shardings``)."""
    from torch.distributed.tensor import DTensor
    full = {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in batch.items()}
    return shard_tree(full, batch_shardings(cfg, mesh, shape, full))


def _onto(tree, shardings):
    """DTensor leaves of ``tree`` redistributed onto ``shardings``."""
    return tree_map(lambda x, sh: _redistribute(x, sh[1]), tree, shardings)


@contextlib.contextmanager
def _sharded_context(rules):
    """The rules active, plain tensors taken as replicated beside
    DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import use_rules
    with use_rules(rules), implicit_replication():
        yield


def init_opt_state(cfg: ArchConfig, params, osh=None) -> AdamWState:
    """Zero moments in the config's state dtype and a zero count; with
    ``osh`` (``state_shardings``' third entry) DTensors on it."""
    if osh is None:
        return adamw_init(params, _state_dtype(cfg))
    from torch.distributed.tensor import zeros

    def z(p, sh):
        return zeros(tuple(p.shape), dtype=_state_dtype(cfg),
                     device_mesh=sh[0], placements=list(sh[1]))
    return AdamWState(m=tree_map(z, params, osh.m),
                      v=tree_map(z, params, osh.v),
                      count=zeros((), dtype=torch.int32,
                                  device_mesh=osh.count[0],
                                  placements=list(osh.count[1])))


def abstract_opt_state(cfg: ArchConfig, abstract_params) -> AdamWState:
    """The optimizer state's shapes and dtypes on the ``meta`` device."""
    dtype = _state_dtype(cfg)
    z = tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"),
                 abstract_params)
    return AdamWState(m=z, v=tree_map(lambda x: x, z),
                      count=torch.empty((), dtype=torch.int32, device="meta"))


def _serving(cfg, mesh, shape):
    """(rules, psh, csh, the step's context, its batch placement) of a
    serving step: Nones, ``inference_mode`` and the identity on one
    device; on a mesh the rules under ``no_grad`` (DTensor's views of a
    shard cannot be made of inference tensors)."""
    _check_shape(shape)
    if not _serving_mesh(mesh):
        return None, None, None, torch.inference_mode, _identity
    from repro_torch.models.common import logical_axes
    from repro_torch.parallel import make_rules
    from repro_torch.parallel.rules import serving_param_shardings
    sp = SHAPES[shape]
    rules = make_rules(mesh, cfg, shape)
    psh = serving_param_shardings(rules, logical_axes(T.model_specs(cfg)))
    csh = cache_shardings(cfg, rules, sp.global_batch, sp.seq_len)

    @contextlib.contextmanager
    def context():
        with torch.no_grad(), _sharded_context(rules):
            yield
    return (rules, psh, csh, context,
            functools.partial(_place_batch, cfg, mesh, shape))


def make_prefill_step(cfg: ArchConfig, mesh=None, shape: str = "prefill_32k",
                      s_max: int | None = None):
    """Returns (prefill, rules, psh, csh), the last three None on one
    device: prefill(params, batch) -> (last logits, caches) with caches of
    ``s_max`` rows (default ``SHAPES[shape].seq_len``; on a mesh DTensors
    laid out as ``csh``)."""
    rules, psh, csh, context, place = _serving(cfg, mesh, shape)
    s_max = SHAPES[shape].seq_len if s_max is None else s_max

    def fn(params, batch):
        with context():
            return T.prefill(cfg, params, place(batch), s_max)
    return fn, rules, psh, csh


def make_decode_step(cfg: ArchConfig, mesh=None, shape: str = "decode_32k"):
    """Returns (decode, rules, psh, csh), the last three None on one
    device: decode(params, caches, batch) -> (logits, caches); the caches
    are written in place, always (what the reference's ``donate`` buys),
    on a mesh each rank its own shard.  ``shape`` names the cell, as in
    ``make_train_step``; a mesh's caches may have any rows (a prefill
    under the rules, or ``shard_tree`` of one device's, onto ``csh``)."""
    rules, psh, csh, context, place = _serving(cfg, mesh, shape)

    def fn(params, caches, batch):
        with context():
            return T.decode_step(cfg, params, caches, place(batch))
    return fn, rules, psh, csh

