"""PyTorch port, partition metrics: ``repro_torch.core.metrics`` (NMI,
ARI) against the JAX package's ``repro.core.metrics`` on the inputs of
``tests/test_metrics.py``: the same floats to 1e-12, and the ground-truth
recovery of a planted partition by the port's ``gsl_lpa``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graphgen as jgen  # noqa: E402
from repro.core import gsl_lpa as j_gsl_lpa  # noqa: E402
from repro.core.metrics import (  # noqa: E402
    adjusted_rand_index as j_ari,
    normalized_mutual_info as j_nmi,
)
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.gsl import gsl_lpa  # noqa: E402
from repro_torch.core.metrics import (  # noqa: E402
    adjusted_rand_index,
    normalized_mutual_info,
)

FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
PAIRS = {
    "identical": lambda: (np.array([0, 0, 1, 1, 2, 2]),) * 2,
    "relabelled": lambda: (np.array([0, 0, 1, 1, 2, 2]),
                           np.array([5, 5, 9, 9, 1, 1])),
    "independent": lambda: tuple(np.random.default_rng(0).integers(
        0, 4, (2, 4000))),
    "one_block": lambda: (np.zeros(7, int), np.arange(7)),
    "both_one_block": lambda: (np.zeros(5, int), np.full(5, 3)),
    "single": lambda: (np.array([4]), np.array([2])),
    "nested": lambda: (np.repeat(np.arange(4), 6), np.repeat(np.arange(8),
                                                             3)),
}


def _both(a, b):
    return ((j_nmi(a, b), normalized_mutual_info(a, b)),
            (j_ari(a, b), adjusted_rand_index(a, b)))


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_metrics_match_reference(case):
    a, b = PAIRS[case]()
    for want, got in _both(a, b):
        assert isinstance(got, float)
        assert got == pytest.approx(want, abs=1e-12, rel=0)


def test_identical_and_relabelled_partitions_score_one():
    for case in ("identical", "relabelled"):
        a, b = PAIRS[case]()
        assert normalized_mutual_info(a, b) == pytest.approx(1.0)
        assert adjusted_rand_index(a, b) == pytest.approx(1.0)


def test_independent_partitions_near_zero():
    a, b = PAIRS["independent"]()
    assert abs(adjusted_rand_index(a, b)) < 0.02
    assert normalized_mutual_info(a, b) < 0.02


# the reference's property test draws n in [2, 30], k in [1, 5] and a seed
@pytest.mark.parametrize("n,k,seed", [
    (2, 1, 0), (2, 2, 1), (3, 5, 2), (7, 3, 3), (12, 4, 4), (20, 2, 5),
    (30, 5, 6), (30, 1, 7), (17, 5, 999), (25, 3, 1000)])
def test_metric_bounds_symmetry_and_reference(n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, k, n)
    b = rng.integers(0, k, n)
    nmi, ari = normalized_mutual_info(a, b), adjusted_rand_index(a, b)
    assert -1e-9 <= nmi <= 1 + 1e-9
    assert -1.000001 <= ari <= 1 + 1e-9
    assert nmi == pytest.approx(normalized_mutual_info(b, a), abs=1e-9)
    assert ari == pytest.approx(adjusted_rand_index(b, a), abs=1e-9)
    for want, got in _both(a, b):
        assert got == pytest.approx(want, abs=1e-12, rel=0)


def test_lengths_must_agree():
    with pytest.raises(ValueError, match="length"):
        normalized_mutual_info(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError, match="length"):
        adjusted_rand_index(np.zeros(3), np.zeros(4))


def test_gsl_lpa_recovers_planted_partition():
    g, truth = jgen.planted_partition(8, 50, p_in=0.35, p_out=0.002,
                                      seed=21)
    pg = tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))
    got = gsl_lpa(pg, split="lp", device="cpu").labels
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(j_gsl_lpa(g, split="lp").labels)
    assert np.array_equal(got, want)
    nmi, ari = normalized_mutual_info(got, truth), adjusted_rand_index(
        got, truth)
    assert nmi > 0.9 and ari > 0.8
    assert nmi == pytest.approx(j_nmi(want, truth), abs=1e-12, rel=0)
    assert ari == pytest.approx(j_ari(want, truth), abs=1e-12, rel=0)
