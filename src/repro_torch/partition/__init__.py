"""Out-of-core partitioned detection: graphs bigger than memory.

The slice behind ``Engine.fit(graph_or_path, memory_budget=...)``:

  * :mod:`repro_torch.partition.plan`    degree-balanced contiguous CSR
    partitioning + per-partition halo sets, from ``row_ptr`` alone.
  * :mod:`repro_torch.partition.slices`  zero-copy partition windows off
    the store's single map, under a hard resident-byte budget (ledger +
    budget-bounded LRU of resident partitions, prefetch, label caches on
    the device).
  * :mod:`repro_torch.partition.ooc`     the sweep loop: shared global
    label array on the host, halo-label gather/scatter per sweep, each
    partition's sweep on the engine's device (the tile backend's four
    LPA kernels on CUDA), labels equal to the in-core fit's bit for bit.

The port's own copy of the JAX package's ``repro.partition``.
"""
from repro_torch.partition.ooc import (  # noqa: F401
    OocRun,
    fit_out_of_core,
    in_core_edge_bytes,
    open_source,
)
from repro_torch.partition.plan import (  # noqa: F401
    Partition,
    PartitionPlan,
    attach_halos,
    halo_of,
    parse_bytes,
    plan_partitions,
)
from repro_torch.partition.slices import (  # noqa: F401
    HaloLabelCache,
    InMemorySource,
    MemoryBudgetExceeded,
    MemoryLedger,
    SliceLoader,
    StoreEntrySource,
    load_partition,
)
