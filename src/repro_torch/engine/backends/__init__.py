"""Execution-strategy backends for the Engine.

Importing this package registers ``segment`` (edge-list sort + segment
reductions) and ``tile`` (padded-neighbor tiles over the LPA kernels).
"""
from repro_torch.engine.backends import segment, tile  # noqa: F401
