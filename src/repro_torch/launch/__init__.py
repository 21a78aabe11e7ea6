"""Host-side entry points over the engine: micro-batching, streaming
re-detection, the ingest, observability and serving CLIs, and the device
meshes and rank launcher of multi-device detection (``mesh``)."""
