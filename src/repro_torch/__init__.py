"""GSL-LPA in PyTorch with hand-written CUDA kernels for the H100.

The counterpart of the JAX package ``repro``, module for module: graphs
(``core.graph``), propagation and Split-Last (``core``), the four LPA
kernels and flash attention (``kernels``), the in-core ``Engine.fit`` and
the batched ``Engine.fit_many`` (``engine``), graph deltas (``core.delta``),
graph-file ingestion (``io``), out-of-core detection under a memory budget
(``partition``), observability (``obs``), the micro-batching
scheduler, streaming sessions and the ingest and obs CLIs (``launch``),
and LM serving of the dense decoder archs (``configs``, ``models``,
``launch.serve``) with document clustering (``data``).
It imports neither JAX nor the JAX package.
"""
