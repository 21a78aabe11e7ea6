"""Train / prefill / decode step builders on one device.

The port of ``repro.train.steps``.  Each builder returns the reference's
tuple, ``(step function, rules, param shardings, state shardings)``, with
``None`` for the three sharding entries: the port runs on one card, and
``state_shardings``, ``batch_shardings`` and the sharding rules wait for
``parallel/`` (ROADMAP Queue A).  A mesh of more than one device raises
``unported``.

Train step semantics (the reference's):
  * the loss in float32, parameters and gradients in the parameters'
    dtype (bf16 for the configs); gradients from autograd;
  * optional microbatch gradient accumulation: a float32 accumulator,
    each microbatch's gradient divided by k and added, cast back to the
    parameters' dtype; the loss is the microbatches' mean;
  * remat comes from the arch config (``models.transformer``'s groups);
  * AdamW (``optim.adamw_update``) with the cosine lr.  ``donate``
    updates the parameters and the optimizer state in place (the
    reference donates their buffers to XLA), so a step holds one copy of
    each.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

__all__ = ["abstract_opt_state", "init_opt_state", "make_decode_step",
           "make_prefill_step", "make_train_step"]


def _check_mesh(mesh) -> None:
    """None, or a mesh of one device (a ``DeviceMesh`` or anything with a
    ``size``); more raises ``unported``."""
    if mesh is None:
        return
    size = mesh.size
    n = size() if callable(size) else size
    if n != 1:
        from repro_torch.engine.config import unported
        raise unported("parallel/ (ZeRO-1, tensor parallel)")


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
    """Returns (step, None, None, None).

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
    """
    _check_mesh(mesh)
    _check_shape(shape)

    def compute_grads(params, batch):
        if microbatch and microbatch > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses = []
            parts = {k: v.reshape((microbatch, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            for i in range(microbatch):
                loss, g = _loss_and_grads(cfg, params,
                                          {k: v[i] for k, v in parts.items()})
                tree_map(lambda a, gg: a.add_(gg.to(torch.float32)
                                              / microbatch), acc, g)
                losses.append(loss)
            return torch.mean(torch.stack(losses)), tree_map(
                lambda a, p: a.to(p.dtype), acc, params)
        return _loss_and_grads(cfg, params, batch)

    def step_fn(params, opt_state, batch, step_idx):
        loss, grads = compute_grads(params, batch)
        lr = cosine_schedule(step_idx, peak_lr=peak_lr, warmup_steps=warmup,
                             total_steps=total_steps)
        new_params, new_opt, metrics = adamw_update(
            grads, opt_state, params, float(lr), in_place=donate)
        metrics.update(loss=loss, lr=lr)
        if keep_grads:
            metrics["grads"] = grads
        return new_params, new_opt, metrics

    return step_fn, None, None, None


def init_opt_state(cfg: ArchConfig, params) -> AdamWState:
    return adamw_init(params, _state_dtype(cfg))


def abstract_opt_state(cfg: ArchConfig, abstract_params) -> AdamWState:
    """The optimizer state's shapes and dtypes on the ``meta`` device."""
    dtype = _state_dtype(cfg)
    z = tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"),
                 abstract_params)
    return AdamWState(m=z, v=tree_map(lambda x: x, z),
                      count=torch.empty((), dtype=torch.int32, device="meta"))


def make_prefill_step(cfg: ArchConfig, mesh=None, shape: str = "prefill_32k"):
    """Returns (prefill, None, None, None): prefill(params, batch) -> (last
    logits, caches) with caches of ``SHAPES[shape].seq_len`` rows."""
    _check_mesh(mesh)
    _check_shape(shape)
    s_max = SHAPES[shape].seq_len

    def fn(params, batch):
        with torch.inference_mode():
            return T.prefill(cfg, params, batch, s_max)
    return fn, None, None, None


def make_decode_step(cfg: ArchConfig, mesh=None, shape: str = "decode_32k"):
    """Returns (decode, None, None, None): decode(params, caches, batch) ->
    (logits, caches); the caches are written in place, always (what the
    reference's ``donate`` buys).  ``shape`` names the cell, as in
    ``make_train_step``."""
    _check_mesh(mesh)
    _check_shape(shape)

    def fn(params, caches, batch):
        with torch.inference_mode():
            return T.decode_step(cfg, params, caches, batch)
    return fn, None, None, None

