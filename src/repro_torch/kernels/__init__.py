"""The hand-written kernels (the four LPA kernels and flash attention):
CUDA on the card (``csrc/``), plain PyTorch on the CPU (``ref.py``),
dispatched by ``ops.py``."""
