"""Host-side entry points over the engine: micro-batching, streaming
re-detection and the ingest CLI."""
