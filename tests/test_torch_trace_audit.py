"""PyTorch port, plan audit: ``repro_torch.analysis.TraceAudit`` and the
audit workload, against the JAX package's ``repro.analysis``.

The counterparts of ``tests/test_trace_audit.py``: attribution of plan
builds to ``plan_context(backend, bucket)``, a record landing in its bin,
an excess bin raising, one build being clean, and the workload gate —
solo, same-bucket, warm, batched, sharded (one rank) and out-of-core
fits under one audit with zero excess plan builds.  Then parity: the
port's ``run_workload(device="cpu")`` returns the reference's coverage
dict, and each of its fits gives the labels of the same fit in the
reference's own workload, bit for bit (the weights are integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis.workload import run_workload as jrun_workload  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    ExcessRetraceError,
    TraceAudit,
    audit_workload,
)
from repro_torch.engine import PLAN_LOG, PlanCache  # noqa: E402
from repro_torch.engine.cache import (  # noqa: E402
    current_plan_context,
    plan_context,
)
from repro_torch.kernels import build  # noqa: E402


@pytest.fixture(scope="module")
def workload():
    """One audited CPU run of the workload, with every fit's labels."""
    labels = {}
    audit = audit_workload(device="cpu", labels=labels)
    return audit, labels


def test_plan_context_attribution():
    assert current_plan_context() is None
    with plan_context("segment", (256, 2048, 128)):
        assert current_plan_context() == ("segment", (256, 2048, 128))
        with plan_context("tile", [8]):
            assert current_plan_context() == ("tile", (8,))
        assert current_plan_context() == ("segment", (256, 2048, 128))
    assert current_plan_context() is None


def test_record_lands_in_current_context():
    cache = PlanCache()
    before = PLAN_LOG.context_snapshot()
    with plan_context("fake-backend", (1, 2)):
        cache.get_or_build("k", lambda: PLAN_LOG.record("fake-backend:stage"))
        cache.get_or_build("k", lambda: PLAN_LOG.record("fake-backend:stage"))
    after = PLAN_LOG.context_snapshot()
    key = ("fake-backend:stage", ("fake-backend", (1, 2)), cache.serial)
    assert after.get(key, 0) - before.get(key, 0) == 1
    # the plain per-tag counters keep working for the engine's stats()
    assert PLAN_LOG.snapshot()["fake-backend:stage"] >= 1


def test_audit_detects_excess():
    with TraceAudit() as audit:
        with plan_context("fake-backend", (3, 4)):
            PLAN_LOG.record("fake-backend:stage")
            PLAN_LOG.record("fake-backend:stage")
    key = ("fake-backend:stage", ("fake-backend", (3, 4)), None)
    assert audit.excess() == {key: 2}
    report = audit.report()
    assert not report["ok"] and report["excess_contexts"] == 1
    with pytest.raises(ExcessRetraceError, match="fake-backend:stage"):
        audit.assert_no_excess()


def test_audit_single_build_is_clean(tmp_path):
    """One build per bin is clean, and so is a second cache building its
    own plan once (an Engine with a PlanCache of its own)."""
    with TraceAudit() as audit:
        with plan_context("fake-backend", (5, 6)):
            for cache in (PlanCache(), PlanCache()):
                cache.get_or_build("k", lambda: PLAN_LOG.record(
                    "fake-backend:stage"))
    assert audit.excess() == {}
    report = audit.write_json(tmp_path / "audit.json")
    assert report["ok"] and (tmp_path / "audit.json").exists()
    assert report["total_traces"] == 2


def test_library_loads_past_one_are_excess(monkeypatch):
    with TraceAudit() as audit:
        monkeypatch.setitem(build.LIBRARY_EVENTS, "loads", 2)
    assert audit.library_events()["loads"] == 2
    assert not audit.report()["ok"]
    with pytest.raises(ExcessRetraceError, match="kernel library"):
        audit.assert_no_excess()


def test_workload_zero_excess_plan_builds(workload):
    """The acceptance gate: solo + same-bucket + warm + batched + sharded
    + out-of-core, all under one audit, zero excess plan builds."""
    audit, _ = workload
    report = audit.report()
    assert report["ok"], report
    assert audit.excess() == {}
    audit.assert_no_excess()
    # the CPU path loads no kernel library
    assert report["library"]["loads"] == report["library"]["builds"] == 0
    # the workload genuinely exercised every dispatch family
    stages = {row["stage"] for row in report["contexts"]}
    for expected in ("segment:propagate", "segment:split",
                     "segment:batch_propagate", "segment:partition",
                     "tile:propagate", "tile:propagate_fused",
                     "tile:batch_propagate", "tile:batch_propagate_fused",
                     "tile:partition", "tile:partition_fused",
                     "sharded:propagate", "sharded:split"):
        assert expected in stages, f"workload never built {expected}"
    buckets = {row["backend"]: row["bucket"] for row in report["contexts"]
               if row["stage"].endswith(":partition")}
    assert buckets["segment"][0] == "partition"


@pytest.fixture(scope="module")
def reference():
    """The JAX package's own workload, run once, with every fit's labels
    in call order (``fit_many`` members in member order)."""
    import repro.engine
    seen = []

    class Recording(JEngine):
        depth = 0

        def fit(self, *args, **kwargs):
            Recording.depth += 1
            try:
                res = super().fit(*args, **kwargs)
            finally:
                Recording.depth -= 1
            if Recording.depth == 0:
                seen.append(np.asarray(res.labels))
            return res

        def fit_many(self, *args, **kwargs):
            Recording.depth += 1
            try:
                res = super().fit_many(*args, **kwargs)
            finally:
                Recording.depth -= 1
            seen.extend(np.asarray(r.labels) for r in res)
            return res

    saved = repro.engine.Engine
    repro.engine.Engine = Recording
    try:
        coverage = jrun_workload()
    finally:
        repro.engine.Engine = saved
    return coverage, seen


def test_workload_coverage_matches_reference(workload, reference):
    audit, _ = workload
    assert audit.coverage == reference[0] \
        == {"fits": 25, "sharded": True, "ooc": True}


def test_workload_labels_match_reference(workload, reference):
    """Every fit of the workload, cold, same-bucket, warm, batched,
    sharded and out of core, gives the reference's labels in the same
    leg; the weights are integers, so they are bit-exact."""
    _, labels = workload
    ours = list(labels.items())
    assert len(ours) == len(reference[1]) == 26
    for (leg, got), want in zip(ours, reference[1]):
        assert got.dtype == want.dtype and np.array_equal(got, want), leg
