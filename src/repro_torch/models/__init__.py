"""LM models of the port: parameter plumbing (``common``), layers,
attention over the flash-attention kernel, the decoder-only transformer,
and ``convert`` (the reference's weights carried over)."""
