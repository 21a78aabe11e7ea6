"""The representative audit workload: every execution path, twice.

The JAX package's legs (``repro.analysis.workload``), in its order, on
its graphs and seeds.  Each leg runs a *cold* fit (one plan build per
stage is expected) followed by same-bucket / warm / repeat traffic that
must build nothing:

* solo cold + same-bucket second graph + warm refit (segment, tile);
* batched ``fit_many`` twice over the same batch bucket;
* fused tile sweeps (``fuse_sweeps="on"``): solo cold + same-bucket,
  batched, and an out-of-core fit — their own plans and stage tags;
* sharded solo (``mesh=None`` and no process group: one rank) cold +
  same-bucket;
* out-of-core partitioned fit, cold + warm repeat (segment, tile), then
  unfused segment (``fuse_sweeps="off"``) and fused tile partition
  sweeps explicitly.

Each Engine has a fresh :class:`~repro_torch.engine.cache.PlanCache` of
its own, so plans built earlier in the process (``GLOBAL_CACHE``) never
turn a cold fit into a hit.  ``device`` is where the fits run: CUDA by
default, as every entry point of the port; on CUDA the tile legs launch
B3 / B4 (``auto`` fuses there) and the sharded leg B1 / B2.

Sized to stay cheap enough for CI (a few hundred vertices per graph)
while still exercising the plan cache across every dispatch family.
"""
from __future__ import annotations

from typing import Any

from repro_torch.analysis.trace_audit import TraceAudit


def _tight_budget(graph, backend: str) -> int:
    """Well under the in-core edge bytes, so the fit must partition
    (tile's floor covers one partition's tiles)."""
    from repro_torch.partition.ooc import IN_CORE_EDGE_BYTES
    in_core = graph.m_pad * IN_CORE_EDGE_BYTES
    if backend == "tile":
        return max(in_core // 2, 20_000)
    return in_core // 3


def run_workload(include_sharded: bool = True, include_ooc: bool = True,
                 device=None, labels: dict | None = None) -> dict[str, Any]:
    """Run the audit workload; returns simple coverage counters (the JAX
    package's).  ``labels``: when given, every fit's compacted labels are
    stored in it under ``"<leg>:<fit>"`` (``"segment:cold"``,
    ``"tile:batch[1]"``, ``"ooc_tile:warm"``, ...)."""
    from repro_torch.engine import Engine, EngineConfig, PlanCache
    from repro_torch.graphgen import erdos_renyi

    def keep(leg, res):
        if labels is not None:
            if isinstance(res, list):
                for i, r in enumerate(res):
                    labels[f"{leg}[{i}]"] = r.labels
            else:
                labels[leg] = res.labels
        return res

    def engine(**kw):
        return Engine(EngineConfig(warm_start="auto", device=device, **kw),
                      cache=PlanCache())

    eng = engine()
    g1 = erdos_renyi(200, 5.0, seed=1)
    g2 = erdos_renyi(230, 5.0, seed=2)   # same pow2 bucket as g1
    fits = 0

    for backend in ("segment", "tile"):
        keep(f"{backend}:cold", eng.fit(g1, backend=backend))
        keep(f"{backend}:same_bucket", eng.fit(g2, backend=backend))
        r = keep(f"{backend}:warm", eng.fit(g2, backend=backend))
        assert r.warm_started and r.cache_hit
        keep(f"{backend}:batch", eng.fit_many([g1, g2], backend=backend))
        keep(f"{backend}:batch_again",
             eng.fit_many([g2, g1], backend=backend))
        fits += 7

    # fused tile sweeps (fuse_sweeps="on" forces fusion on the CPU too):
    # solo cold + same-bucket + batched — the *_fused stages
    feng = engine(fuse_sweeps="on")
    keep("tile_fused:cold", feng.fit(g1, backend="tile"))
    r = keep("tile_fused:same_bucket", feng.fit(g2, backend="tile"))
    assert r.cache_hit
    keep("tile_fused:batch", feng.fit_many([g1, g2], backend="tile"))
    fits += 3

    if include_sharded:
        keep("sharded:cold", eng.fit(g1, backend="sharded"))
        r = keep("sharded:same_bucket", eng.fit(g2, backend="sharded"))
        assert r.cache_hit
        fits += 2

    if include_ooc:
        # denser graph: tile's budget floor must stay well under the
        # in-core edge bytes or nothing partitions
        g3 = erdos_renyi(400, 16.0, seed=4)
        for backend in ("segment", "tile"):
            budget = _tight_budget(g3, backend)
            r = keep(f"ooc_{backend}:cold",
                     eng.fit(g3, backend=backend, memory_budget=budget))
            assert r.partitions > 1, "budget did not force partitioning"
            r = keep(f"ooc_{backend}:warm",
                     eng.fit(g3, backend=backend, memory_budget=budget))
            assert r.warm_started
            fits += 2
        # the other half of the fused matrix: segment fuses its partition
        # sweeps under "auto" everywhere, tile only on CUDA — so run
        # unfused segment and fused tile partition sweeps explicitly
        oeng = engine(fuse_sweeps="off")
        r = keep("ooc_segment_unfused:cold",
                 oeng.fit(g3, backend="segment",
                          memory_budget=_tight_budget(g3, "segment")))
        assert r.partitions > 1
        r = keep("ooc_tile_fused:cold",
                 feng.fit(g3, backend="tile",
                          memory_budget=_tight_budget(g3, "tile")))
        assert r.partitions > 1
        fits += 2

    return {"fits": fits, "sharded": include_sharded, "ooc": include_ooc}


def audit_workload(include_sharded: bool = True, include_ooc: bool = True,
                   device=None, labels: dict | None = None) -> TraceAudit:
    """Run the workload under a :class:`TraceAudit`; caller inspects
    ``report()`` / ``assert_no_excess()`` (and ``audit.coverage``)."""
    with TraceAudit() as audit:
        coverage = run_workload(include_sharded=include_sharded,
                                include_ooc=include_ooc, device=device,
                                labels=labels)
    audit.coverage = coverage
    return audit
