"""Atomic, keep-k checkpoints of named tensors (the port's copy of
``repro.checkpoint``; the two packages read each other's files)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
