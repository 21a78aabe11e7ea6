"""GSL-LPA in PyTorch with hand-written CUDA kernels for the H100.

The counterpart of the JAX package ``repro``, module for module: graphs
(``core.graph``), propagation and Split-Last (``core``), the four LPA
kernels (``kernels``) and the solo in-core ``Engine.fit`` (``engine``).
It imports neither JAX nor the JAX package.
"""
