"""PyTorch port, ``data.clustering`` and the community pipeline example
against the JAX package.

The document graph is built on the host by the same numpy code, and the
detection is the port's GSL-LPA, which equals the reference label for
label; so the labels and the batches must be equal exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import clustering as jclust  # noqa: E402
from repro_torch.data import clustering as tclust  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAPH_FIELDS = ("row_ptr", "src", "dst", "wgt", "edge_mask", "kdeg")


def topic_corpus(k=4, per=6, seq=64, vocab=4096, seed=0):
    """tests/test_data.py's corpus: docs from k disjoint vocab blocks."""
    rng = np.random.default_rng(seed)
    docs = np.zeros((k * per, seq), dtype=np.int64)
    for t in range(k):
        lo = t * (vocab // k)
        for i in range(per):
            docs[t * per + i] = rng.integers(lo, lo + vocab // k, size=seq)
    return docs


def mixed_corpus(seed):
    """Overlapping random documents: a graph with uneven communities."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 600, size=(30, 24))


@pytest.mark.parametrize("corpus", ["topics", "mixed1", "mixed2"])
def test_doc_similarity_graph_matches_reference(corpus):
    docs = topic_corpus() if corpus == "topics" else mixed_corpus(
        int(corpus[-1]))
    want = jclust.doc_similarity_graph(docs)
    got = tclust.doc_similarity_graph(docs)
    assert got.n == want.n and got.device.type == "cpu"
    for f in GRAPH_FIELDS:
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f


@pytest.mark.parametrize("split", ["lp", "lpp", "bfs_host"])
@pytest.mark.parametrize("corpus", ["topics", "mixed1", "mixed2"])
def test_cluster_documents_matches_reference(corpus, split):
    docs = topic_corpus() if corpus == "topics" else mixed_corpus(
        int(corpus[-1]))
    want = jclust.cluster_documents(docs, split=split)
    got = tclust.cluster_documents(docs, device="cpu", split=split)
    assert np.array_equal(np.asarray(want), got)


def test_locality_batches_match_reference_and_recover_topics():
    docs = topic_corpus()
    labels = tclust.cluster_documents(docs, device="cpu")
    for t in range(4):
        assert len(set(labels[t * 6:(t + 1) * 6].tolist())) == 1
    assert len(set(labels.tolist())) == 4
    want = jclust.locality_batches(docs, 6)
    got = tclust.locality_batches(docs, 6, device="cpu")
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_edgeless_corpus_gets_a_placeholder_edge():
    docs = np.arange(3 * 8).reshape(3, 8) * 1000
    want = jclust.doc_similarity_graph(docs)
    got = tclust.doc_similarity_graph(docs)
    assert got.num_edges == want.num_edges == 2
    assert np.array_equal(np.asarray(jclust.cluster_documents(docs)),
                          tclust.cluster_documents(docs, device="cpu"))


def test_community_pipeline_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "community_pipeline_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "restart == uninterrupted: OK (bit-exact)" in out
    assert "gsl_lpa == Engine: OK" in out
    assert "disconnected=0.0%" in out
    assert "documents: 24 in 4 communities, 4 locality batches" in out
