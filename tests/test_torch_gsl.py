"""PyTorch port, the ``gsl_lpa`` / ``gve_lpa`` facades against the JAX
package's on the reference's ``test_gsl`` graphs, for every split method;
and ``examples/quickstart_torch.py`` on the CPU.

Labels and iteration counts must be equal (integer weights).  The port
runs with ``device="cpu"``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import core as jcore  # noqa: E402
from repro import graphgen as jgen  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SPLIT_METHODS,
    GslResult,
    disconnected_fraction,
    gsl_lpa,
    gve_lpa,
    modularity,
)
from repro_torch.core import graph as tgraph  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")
GRAPHS = {
    "karate": lambda: jgen.karate_club()[0],
    "ring": lambda: jgen.ring_of_cliques(10, 5),
    "planted": lambda: jgen.planted_partition(8, 40, 0.3, 0.004, seed=2)[0],
    "er": lambda: jgen.erdos_renyi(400, 6.0, seed=4),
    "rmat": lambda: jgen.rmat(10, 8, seed=6),
}


def port_of(g):
    return tgraph.graph_from_arrays(
        g.n, g.num_edges, *(np.asarray(getattr(g, f)) for f in FIELDS))


def assert_same(want, got, ctx):
    assert isinstance(got, GslResult)
    assert np.array_equal(want.labels, got.labels), ctx
    assert want.lpa_iterations == got.lpa_iterations, ctx
    assert want.split_iterations == got.split_iterations, ctx


@pytest.mark.parametrize("split", SPLIT_METHODS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gsl_lpa_matches_reference(name, split):
    g = GRAPHS[name]()
    want = jcore.gsl_lpa(g, split=split)
    got = gsl_lpa(port_of(g), split=split, device="cpu")
    assert_same(want, got, (name, split))
    if split != "none":
        assert float(disconnected_fraction(port_of(g),
                                           torch.from_numpy(got.labels))) == 0.0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gve_lpa_matches_reference(name):
    g = GRAPHS[name]()
    want = jcore.gve_lpa(g)
    got = gve_lpa(port_of(g), split="lp", device="cpu")   # split is dropped
    assert_same(want, got, name)
    assert got.split_iterations == 0
    q_gve = float(modularity(port_of(g), torch.from_numpy(got.labels)))
    q_gsl = float(modularity(port_of(g), torch.from_numpy(
        gsl_lpa(port_of(g), device="cpu").labels)))
    assert q_gsl >= q_gve - 1e-6


@pytest.mark.parametrize("kw", [dict(shortcut=True, split="lpp"),
                                dict(tau=0.0, max_iterations=3),
                                dict(tau=0.2)],
                         ids=["shortcut-lpp", "cap", "tau"])
def test_gsl_lpa_options_match_reference(kw):
    g = GRAPHS["er"]()
    assert_same(jcore.gsl_lpa(g, **kw), gsl_lpa(port_of(g), device="cpu",
                                                  **kw), kw)


def test_gsl_lpa_warm_start_matches_reference():
    g = GRAPHS["planted"]()
    cold = jcore.gsl_lpa(g)
    want = jcore.gsl_lpa(g, init_labels=cold.labels)
    got = gsl_lpa(port_of(g), init_labels=cold.labels, device="cpu")
    assert_same(want, got, "warm")
    assert got.detail.warm_started


def test_gsl_result_carries_engine_detail():
    res = gsl_lpa(port_of(GRAPHS["karate"]()), split="lp", device="cpu")
    d = res.detail
    assert d.backend == "segment" and d.device == "cpu"
    assert isinstance(d.cache_hit, bool)
    assert set(d.timings) == {"prepare", "propagation", "split", "compact"}
    assert d.timings["propagation"] == res.lpa_seconds == d.lpa_seconds
    assert res.split_seconds == d.split_seconds > 0
    assert res.total_seconds == res.lpa_seconds + res.split_seconds
    assert np.array_equal(d.labels, res.labels)
    assert d.bucket[0] == 34    # exact bucketing


def test_facades_check_split_and_default_to_cuda():
    g = port_of(GRAPHS["karate"]())
    with pytest.raises(ValueError, match="split"):
        gsl_lpa(g, split="bfs", device="cpu")
    if torch.cuda.is_available():
        return
    for fn in (gsl_lpa, gve_lpa):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(g)


def test_quickstart_torch_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "quickstart_torch.py"),
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "karate club" in out and "disconnected_frac=0.000%" in out
    assert "fit_many of 3 graphs agrees with solo fits: True" in out
    assert "legacy gsl_lpa agrees: True" in out


def test_quickstart_torch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "quickstart_torch.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
