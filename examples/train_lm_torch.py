"""Train a ~100M-parameter LM end to end on the PyTorch port: config ->
synthetic data pipeline -> train step -> checkpointing -> preemption
handling.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]   # CUDA
    PYTHONPATH=src python examples/train_lm_torch.py --steps 8 --seq-len 64 \
        --global-batch 2 --device cpu

The twin of ``examples/train_lm.py``: the same config derived from yi-9b;
on the card every attention runs the flash-attention kernel and its
gradient the flash-attention backward, on the CPU their plain versions.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.train import run


def hundred_m_config():
    """A ~100M llama-family config derived from yi-9b."""
    base = get_config("yi-9b")
    return dataclasses.replace(
        base, n_layers=8, d_model=768, n_heads=12, n_kv=4, head_dim=64,
        d_ff=2048, vocab=8192, remat="none", attn_chunk=128)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda)")
    args = ap.parse_args(argv)

    cfg = hundred_m_config()
    print(f"config: {cfg.n_layers}L d={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.0f}M")

    # register the custom config under a private name and train
    cfg = dataclasses.replace(cfg, name="yi-100m")
    ARCHS["yi-100m"] = cfg

    # lr is tuned for the default 8 x 256 token batch; scale it down for
    # smoke-size batches or the tiny-batch gradient noise diverges
    tokens = args.global_batch * args.seq_len
    peak_lr = 3e-3 * min(1.0, tokens / (8 * 256))

    with tempfile.TemporaryDirectory() as d:
        out = run("yi-100m", reduced=False, steps=args.steps,
                  seq_len=args.seq_len, global_batch=args.global_batch,
                  ckpt_dir=d, save_every=50, log_every=10, peak_lr=peak_lr,
                  device=args.device)
    losses = out["losses"]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    # single-batch losses are noisy; judge learning on window means, and
    # only once past warmup + a few real update steps
    if len(losses) >= 24:
        k = max(len(losses) // 4, 4)
        first = sum(losses[:k]) / k
        last = sum(losses[-k:]) / k
        assert last < first, f"model did not learn ({first:.3f} -> {last:.3f})"
    return losses


if __name__ == "__main__":
    main()
