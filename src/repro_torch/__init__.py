"""GSL-LPA in PyTorch with hand-written CUDA kernels for the H100.

The counterpart of the JAX package ``repro``, module for module: graphs
(``core.graph``), propagation and Split-Last (``core``), the four LPA
kernels and flash attention (``kernels``), the attention oracle
(``models.attention``), the in-core ``Engine.fit`` and the batched
``Engine.fit_many`` (``engine``), graph deltas (``core.delta``), graph-file
ingestion (``io``), and the micro-batching scheduler, streaming sessions
and ingest CLI (``launch``).
It imports neither JAX nor the JAX package.
"""
