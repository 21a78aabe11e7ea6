"""Mistral-Nemo-12B — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

Full (quadratic) attention: the ``long_500k`` decode cell is skipped per the
assignment rules (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1000000.0,
)
