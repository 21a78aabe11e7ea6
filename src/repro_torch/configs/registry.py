"""Arch registry + reduced (smoke-test) config derivation."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    arctic_480b,
    internvl2_26b,
    jamba_52b,
    mistral_nemo_12b,
    qwen15_32b,
    qwen2_moe_a27b,
    rwkv6_7b,
    seamless_m4t_large_v2,
    starcoder2_15b,
    yi_9b,
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        yi_9b.CONFIG,
        mistral_nemo_12b.CONFIG,
        starcoder2_15b.CONFIG,
        qwen15_32b.CONFIG,
        jamba_52b.CONFIG,
        rwkv6_7b.CONFIG,
        seamless_m4t_large_v2.CONFIG,
        arctic_480b.CONFIG,
        qwen2_moe_a27b.CONFIG,
        internvl2_26b.CONFIG,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """Small same-family config for CPU smoke tests (one real step)."""
    cfg = get_config(name)
    d = 256
    heads = 4 if cfg.kind != "rwkv" else d // 64
    kv = min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else heads
    changes = dict(
        n_layers=cfg.group_size * 2,
        d_model=d,
        n_heads=heads,
        n_kv=kv if cfg.kind != "rwkv" else heads,
        head_dim=64,
        d_ff=512,
        vocab=512,
        frontend_len=8 if cfg.frontend_len else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        cross_memory_len=32,
        lora_r=8,
        attn_chunk=64,
        mamba_chunk=8,
        remat="none",
    )
    if cfg.moe_experts:
        changes.update(moe_experts=4, moe_experts_padded=4, moe_top_k=2,
                       moe_ff=128)
    if cfg.shared_expert_ff:
        changes.update(shared_expert_ff=128)
    return dataclasses.replace(cfg, **changes)
