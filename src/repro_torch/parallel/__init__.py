"""Sharding over ``torch.distributed`` device meshes: the port of
``repro.parallel`` (compat, api, rules)."""
from repro_torch.parallel.api import (
    MeshRules,
    Sharding,
    active_rules,
    shard_hint,
    use_rules,
)
from repro_torch.parallel.compat import abstract_mesh, make_mesh, shard_map
from repro_torch.parallel.rules import (
    cache_logical_axes,
    data_axes,
    make_rules,
    param_shardings,
    zero1_shardings,
)

__all__ = ["MeshRules", "Sharding", "abstract_mesh", "active_rules",
           "cache_logical_axes", "data_axes", "make_mesh", "make_rules",
           "param_shardings", "shard_hint", "shard_map", "use_rules",
           "zero1_shardings"]
