"""SeamlessM4T-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596; hf].

The speech/text frontend is a STUB per the assignment: ``input_specs()``
feeds precomputed frame embeddings (B, S_enc, d) to the encoder; the
transformer backbone (24L enc + 24L dec with cross-attention) is real.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio", kind="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, head_dim=64, norm="layer",
    cross_memory_len=4096,
)
