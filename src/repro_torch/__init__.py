"""GSL-LPA in PyTorch with hand-written CUDA kernels for the H100.

The counterpart of the JAX package ``repro``, module for module: graphs
(``core.graph``), propagation and Split-Last (``core``), the four LPA
kernels and flash attention (``kernels``), the attention oracle
(``models.attention``), the in-core ``Engine.fit`` and the batched
``Engine.fit_many`` (``engine``), graph deltas (``core.delta``), graph-file
ingestion (``io``), out-of-core detection under a memory budget
(``partition``), observability (``obs``), and the micro-batching
scheduler, streaming sessions and the ingest and obs CLIs (``launch``).
It imports neither JAX nor the JAX package.
"""
