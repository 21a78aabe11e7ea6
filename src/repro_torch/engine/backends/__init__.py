"""Execution-strategy backends for the Engine.

Importing this package registers ``segment`` (edge-list sort + segment
reductions), ``tile`` (padded-neighbor tiles over the LPA kernels) and
``sharded`` (row-sharded tiles over ``torch.distributed``).
"""
from repro_torch.engine.backends import segment, sharded, tile  # noqa: F401
