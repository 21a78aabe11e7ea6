"""StarCoder2-15B — GQA + RoPE, LayerNorm/GELU MLP, 4k sliding window
[arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576,
    vocab=49152, head_dim=128, rope_theta=100000.0,
    norm="layer", qkv_bias=True, window=4096,
)
