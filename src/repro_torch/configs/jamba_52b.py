"""Jamba-v0.1 (52B) — Mamba+attention 1:7 hybrid with MoE every other layer
[arXiv:2403.19887; hf].

Scan group = the period-8 block (1 attention layer at offset 4, 7 Mamba
layers; MoE on odd offsets).  Sub-quadratic: runs the ``long_500k`` cell —
only the 4 attention layers hold a 512k KV cache (sequence-sharded, SP).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=65536, head_dim=128,
    moe_experts=16, moe_experts_padded=16, moe_top_k=2, moe_ff=14336,
    moe_period=2, moe_offset=1,
    attn_period=8, attn_offset=4,
    d_state=16, d_conv=4, expand=2,
    group_size=8, supports_long=True,
    optimizer_state_dtype="bfloat16",
)
