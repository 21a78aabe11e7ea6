"""InternVL2-26B — InternViT frontend (STUB) + InternLM2-20B backbone
[arXiv:2404.16821; hf].

``input_specs()`` supplies precomputed patch embeddings (B, 1024, d) which
are prepended to the text sequence; the 48L GQA backbone is real.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=92553, head_dim=128, rope_theta=1000000.0,
    frontend_len=1024,
)
