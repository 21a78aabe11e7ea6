"""RWKV6 "Finch" 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].  Constant-size state: runs ``long_500k``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", kind="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336,
    vocab=65536, head_dim=64, norm="layer",
    lora_r=64, supports_long=True,
)
