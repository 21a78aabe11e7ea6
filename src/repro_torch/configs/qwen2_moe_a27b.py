"""Qwen1.5/2-MoE-A2.7B — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts are padded to 64 for TP divisibility (padded experts
masked to -inf in the router); the 4 shared experts are fused into one
always-on gated FFN of width 4 x 1408 = 5632.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=151936, head_dim=128, qkv_bias=True,
    moe_experts=60, moe_experts_padded=64, moe_top_k=4, moe_ff=1408,
    moe_period=1, moe_offset=0, shared_expert_ff=5632,
)
