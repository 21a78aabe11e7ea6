"""End-to-end community-detection pipeline with checkpoint/restart, on the
PyTorch port.

    PYTHONPATH=src python examples/community_pipeline_torch.py          # CUDA
    PYTHONPATH=src python examples/community_pipeline_torch.py --device cpu

The twin of ``examples/community_pipeline.py``: an SBM graph, a host-driven
LPA loop with a checkpoint after every iteration, a simulated failure at
iteration 2, a restart from the checkpoint that must equal the
uninterrupted run bit for bit, then the recovered labels finished through
the Engine as a warm start (no internally-disconnected community), with
the ``gsl_lpa`` facade checked against it.  Then the document clustering
of ``repro_torch.data.clustering`` on a corpus of four topics.
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import gsl_lpa
from repro_torch.core.lpa import label_hash, lpa_move, neighbors_of
from repro_torch.data.clustering import cluster_documents, locality_batches
from repro_torch.engine import Engine, EngineConfig
from repro_torch.graphgen import planted_partition


def lpa_with_checkpoints(g, mgr: CheckpointManager, max_iters=20, tau=0.05,
                         fail_at: int | None = None, resume: bool = False):
    """Host-driven LPA loop: one sweep pair per step + checkpoint."""
    n, dev = g.n, g.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    parity = (label_hash(ids, -1) & 1).bool()
    state = {"labels": ids.clone(),
             "active": torch.ones(n, dtype=torch.bool, device=dev),
             "iteration": torch.zeros((), dtype=torch.int32, device=dev)}
    start = 0
    if resume and mgr.latest_step() is not None:
        state, start, _ = mgr.restore(state)
        print(f"  resumed from iteration {start}")

    for it in range(start, max_iters):
        labels, active = state["labels"], state["active"]
        dn_total = 0
        for sweep, klass in enumerate((~parity, parity)):
            cand = active & klass
            labels, changed, dn = lpa_move(g, labels, cand, 2 * it + sweep)
            active = (active & ~cand) | neighbors_of(g, changed)
            dn_total += int(dn)
        state = {"labels": labels, "active": active,
                 "iteration": torch.tensor(it + 1, dtype=torch.int32,
                                           device=dev)}
        mgr.save(it + 1, state)
        if fail_at is not None and it + 1 == fail_at:
            raise RuntimeError(f"simulated node failure at iteration {it+1}")
        if dn_total <= tau * n:
            break
    return state["labels"]


def topic_corpus(k=4, per=6, seq=64, vocab=4096, seed=0) -> np.ndarray:
    """Docs drawn from k disjoint vocab blocks, ``per`` docs each."""
    rng = np.random.default_rng(seed)
    docs = np.zeros((k * per, seq), dtype=np.int64)
    for t in range(k):
        lo = t * (vocab // k)
        for i in range(per):
            docs[t * per + i] = rng.integers(lo, lo + vocab // k, size=seq)
    return docs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps and fits run (default: cuda)")
    device = ap.parse_args(argv).device
    g, truth = planted_partition(10, 80, p_in=0.25, p_out=0.002, seed=11)
    print(f"SBM graph: {g.n} vertices, {g.num_edges} directed edges")
    gd = g.to(device)

    with tempfile.TemporaryDirectory() as d:
        # uninterrupted reference
        ref = lpa_with_checkpoints(gd, CheckpointManager(Path(d) / "ref"))

        # interrupted run: fail at iteration 2, restart, complete
        mgr = CheckpointManager(Path(d) / "ft")
        try:
            lpa_with_checkpoints(gd, mgr, fail_at=2)
        except RuntimeError as e:
            print(f"  {e}")
        labels = lpa_with_checkpoints(gd, mgr, resume=True)

    labels = labels.cpu().numpy()
    assert np.array_equal(ref.cpu().numpy(), labels), \
        "restart diverged from uninterrupted run"
    print("  restart == uninterrupted: OK (bit-exact)")

    # Finish through the Engine: the checkpointed labels warm-start the
    # detection (the propagation phase converges almost immediately), the
    # split phase separates any internally-disconnected communities.
    eng = Engine(EngineConfig(backend="segment", compute_metrics=True,
                              device=device))
    res = eng.fit(g, init_labels=labels)
    q, frac = res.modularity, res.disconnected_fraction
    print(f"final: {res.num_communities} communities, Q={q:.3f}, "
          f"disconnected={frac:.1%} "
          f"(warm-start LPA took {res.lpa_iterations} iteration(s))")
    assert frac == 0.0

    # The facade: the same warm start through gsl_lpa matches.
    facade = gsl_lpa(g, init_labels=labels, device=device)
    assert np.array_equal(facade.labels, res.labels), \
        "gsl_lpa diverged from Engine result"
    print("  gsl_lpa == Engine: OK")

    # Locality-aware batches: four topics, four connected communities.
    docs = topic_corpus()
    topics = cluster_documents(docs, device=device)
    batches = locality_batches(docs, 6, device=device)
    print(f"documents: {len(docs)} in {len(set(topics.tolist()))} "
          f"communities, {len(batches)} locality batches")


if __name__ == "__main__":
    main()
