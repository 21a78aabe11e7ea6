"""The four LPA kernels: CUDA on the card (``csrc/``), plain PyTorch on the
CPU (``ref.py``), dispatched by ``ops.py``."""
