"""Qwen1.5-32B — dense, QKV bias [hf:Qwen/Qwen1.5-32B].

Note: 40 heads are not divisible by TP=16; GSPMD pads the head axis (5%
waste on the q projection) — recorded in EXPERIMENTS.md §Roofline notes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
    vocab=152064, head_dim=128, rope_theta=1000000.0, qkv_bias=True,
    # 48 (padded) MHA kv heads x 32k x b128 = 6.6 TB bf16 KV cache — more
    # than a pod's aggregate HBM; int8 cache halves it (EXPERIMENTS §Dry-run)
    kv_cache_dtype="int8",
)
