"""End-to-end LM training driver of the port (reduced configs run on the
CPU in the tests; on the card any config that fits, ``layers`` cutting
depth).

Wires together: config -> data pipeline -> train step -> checkpoint
manager -> preemption handler -> straggler monitor, as
``repro.launch.train`` does.  ``--resume`` restores the parameters, the
optimizer state and the data state from the latest checkpoint.  Runs on
CUDA unless ``device`` (``--device``) says otherwise; on the card every
attention runs the flash-attention kernel and its gradient the
flash-attention backward.

On a mesh (``mesh=``, or with a process group up and no mesh a
(world, 1) ``data`` x ``model`` mesh over the world, as the reference
builds one over its devices) every rank runs ``run`` with the same
arguments: the parameters and the optimizer state are placed on the
rules' shardings, the step is the sharded one (``train.steps``), a
checkpoint holds the full arrays (rank 0 writes) and ``--resume``
restores onto the mesh's shardings.  With no process group it runs on
one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
      --steps 50 --ckpt-dir /tmp/ckpt --save-every 20 [--resume] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.data import SyntheticLMDataset
from repro_torch.ft import PreemptionHandler, StragglerMonitor
from repro_torch.models import transformer as T
from repro_torch.models.common import init_from_specs
from repro_torch.train import steps as S


def build_small_shape(cfg, seq_len: int, global_batch: int) -> str:
    """Register an ad-hoc shape for small runs."""
    name = f"cpu_{seq_len}x{global_batch}"
    SHAPES[name] = ShapeSpec(name, seq_len, global_batch, "train")
    return name


def _upload(batch: dict, dev: torch.device) -> dict:
    """The host batch on ``dev``: one copy a tensor, from pinned memory
    on the card."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def run(arch: str, reduced: bool = True, steps: int = 50,
        seq_len: int = 128, global_batch: int = 8,
        ckpt_dir: str | None = None, save_every: int = 20,
        resume: bool = False, seed: int = 0, mesh=None,
        log_every: int = 10, preempt: PreemptionHandler | None = None,
        peak_lr: float = 1e-3, device=None, layers: int | None = None):
    """Train ``arch`` for ``steps`` steps of ``global_batch`` x
    ``seq_len`` synthetic tokens from ``seed``.  ``layers`` cuts the
    config's depth; ``device=None`` means CUDA.  Returns {"losses",
    "grad_norms", "lrs", "step_s" (host seconds of each step, its loss
    read included), "final_step", "params", "opt_state", "monitor"}."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = torch.device("cuda" if device is None else device)
    if mesh is None and dist.is_initialized():
        from repro_torch.parallel import make_mesh
        mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"),
                         device_type=dev.type)
    shape = build_small_shape(cfg, seq_len, global_batch)

    step_fn, _rules, psh, osh = S.make_train_step(
        cfg, mesh, shape, peak_lr=peak_lr, warmup=5,
        total_steps=max(steps, 100), donate=True)
    params = init_from_specs(T.model_specs(cfg), seed, device=dev)
    if psh is not None:
        params = S.shard_tree(params, psh)
    opt_state = S.init_opt_state(cfg, params, osh)

    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq_len,
                              global_batch=global_batch, seed=seed)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start_step = 0
    if resume and mgr and mgr.latest_step() is not None:
        state = {"params": params, "opt": opt_state}
        restored, ck_step, extra = mgr.restore(
            state, shardings=None if psh is None else
            {"params": psh, "opt": osh})
        params, opt_state = restored["params"], restored["opt"]
        data.restore(extra["data"])
        start_step = ck_step
        print(f"[train] resumed from step {ck_step}", flush=True)

    preempt = (preempt or PreemptionHandler()).install()
    monitor = StragglerMonitor()
    losses, grad_norms, lrs, step_s = [], [], [], []
    t_start = time.time()
    final_step = start_step
    for step in range(start_step, steps):
        monitor.step_start()
        t0 = time.perf_counter()
        batch = _upload(data.next_batch(), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        # lint: host-sync-ok — the step's one read: its loss, for the log,
        # the checkpoint's extra and the straggler monitor's clock
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        grad_norms.append(metrics["grad_norm"])
        lrs.append(float(metrics["lr"]))
        monitor.step_end(step)
        final_step = step + 1
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        want_ckpt = mgr and ((step + 1) % save_every == 0
                             or step == steps - 1 or preempt.should_stop)
        if want_ckpt:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"data": data.state(), "loss": loss},
                     blocking=False)
        if preempt.should_stop:
            print(f"[train] preempted at step {step}; checkpointed",
                  flush=True)
            break
    if mgr:
        mgr.wait()
    dt = time.time() - t_start
    if losses:
        print(f"[train] done: {final_step - start_step} steps in {dt:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return {"losses": losses,
            "grad_norms": [float(g) for g in grad_norms], "lrs": lrs,
            "step_s": step_s, "final_step": final_step, "params": params,
            "opt_state": opt_state, "monitor": monitor}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    a = ap.parse_args(argv)
    run(a.arch, a.reduced, a.steps, a.seq_len, a.global_batch,
        a.ckpt_dir, a.save_every, a.resume, a.seed, device=a.device,
        layers=a.layers)


if __name__ == "__main__":
    main()
