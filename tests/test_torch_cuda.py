"""PyTorch port on the card: the CUDA kernels against their plain versions
and the CUDA engine against the CPU engine.  Imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card the ``cuda`` tests skip; ``chip_smoke.py`` is the full
check on the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch import graphgen  # noqa: E402
from repro_torch.engine import Engine, EngineConfig, PlanCache  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiles(rows, d, seed, device):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, d)) < 0.8
    mask[0] = False
    arrays = dict(
        nbr=rng.integers(0, rows, size=(rows, d)).astype(np.int32),
        nw=rng.integers(1, 5, size=(rows, d)).astype(np.float32),
        nmask=mask,
        labels=rng.integers(0, max(rows // 2, 2), size=rows).astype(np.int32),
        comm=rng.integers(0, 4, size=rows).astype(np.int32),
        chg=rng.random(rows) < 0.3,
        active=rng.random(rows) < 0.6, cand_prev=rng.random(rows) < 0.4,
        klass=rng.random(rows) < 0.7, real=np.arange(rows) < rows - 2)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(64, 1), (64, 4), (32, 40), (8, 1024)])
def test_cuda_kernels_match_plain_versions(rows, d):
    """Integer weights: every kernel equals its plain version exactly."""
    need_card()
    t = tiles(rows, d, seed=3, device="cuda")
    for s in (0, -1, 12345):
        k = ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], s)
        p = ref.label_argmax_ref(t["nbr"], t["nw"], t["nmask"], t["labels"],
                                 s)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        margs = (t["nbr"], t["nw"], t["nmask"], t["labels"], t["chg"],
                 t["active"], t["cand_prev"], t["klass"], t["real"], s)
        k = ops.fused_move(*margs)
        p = ref.fused_move_ref(*margs)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    sargs = (t["nbr"], t["nmask"], t["labels"], t["comm"])
    assert torch.equal(ops.min_label(*sargs), ref.min_label_ref(*sargs))
    for prune in (True, False):
        assert torch.equal(ops.fused_split(*sargs, t["chg"], prune),
                           ref.fused_split_ref(*sargs, t["chg"], prune))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_kernels_reject_rows_wider_than_1024():
    need_card()
    t = tiles(4, 1025, seed=0, device="cuda")
    with pytest.raises(ValueError):
        ops.label_argmax(t["nbr"], t["nw"], t["nmask"], t["labels"], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["none", "lp", "lpp", "bfs_host"])
def test_cuda_engine_matches_cpu_engine(split):
    """Default config on the card: auto picks the tile backend, the
    kernels run, and labels and iteration counts equal the CPU segment
    fit's."""
    need_card()
    ops.reset_launches()
    for g in (graphgen.karate_club()[0], graphgen.erdos_renyi(180, 5.0,
                                                               seed=11),
              graphgen.planted_partition(6, 30, 0.3, 0.01, seed=3)[0],
              graphgen.figure1_graph()[0]):
        got = Engine(EngineConfig(split=split), cache=PlanCache()).fit(g)
        want = Engine(EngineConfig(split=split, device="cpu",
                                   backend="segment"),
                      cache=PlanCache()).fit(g)
        assert got.backend == "tile" and got.device.startswith("cuda")
        assert np.array_equal(got.labels, want.labels)
        assert (got.lpa_iterations, got.split_iterations) == \
            (want.lpa_iterations, want.split_iterations)
    assert ops.LAUNCHES["fused_move"] > 0


def test_port_import_pulls_in_no_jax():
    """Importing the whole port loads neither JAX nor the JAX package."""
    code = ("import sys; import repro_torch.engine, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.graphgen; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})
