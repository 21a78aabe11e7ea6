"""Snowflake Arctic (480B) — 128-expert top-2 MoE + parallel dense residual
[hf:Snowflake/snowflake-arctic-base].

Experts are sharded over ('data','model') = 256-way expert-parallelism;
optimizer state runs in bf16 (distributed-optimization trick, DESIGN.md §6)
— with fp32 Adam state the 480B parameters cannot fit 256 x 16 GB.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    moe_experts=128, moe_experts_padded=128, moe_top_k=2, moe_ff=4864,
    moe_period=1, moe_offset=0, dense_residual=True,
    optimizer_state_dtype="bfloat16",
)
