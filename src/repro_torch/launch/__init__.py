"""Host-side schedulers over the engine (micro-batching)."""
