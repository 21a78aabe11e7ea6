"""PyTorch port, ``data.clustering``, ``data.pipeline`` and the community
pipeline and LM training examples against the JAX package.

The document graph is built on the host by the same numpy code, and the
detection is the port's GSL-LPA, which equals the reference label for
label; so the labels and the batches must be equal exactly.  The
synthetic LM stream is the same numpy code too: its tokens must be equal
bit for bit for every (seed, host, host count, step), restored state
included.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.data import clustering as jclust  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TData  # noqa: E402
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


# --- the synthetic LM stream (data.pipeline) ----------------------------

@pytest.mark.parametrize("host_count", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_synthetic_lm_dataset_bit_identical(seed, host_count):
    """Every host's batches over 3 steps, then a restore of step 1's
    state on a fresh stream replays step 1 on."""
    kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=seed,
              host_count=host_count)
    for host in range(host_count):
        j, t = JData(host_index=host, **kw), TData(host_index=host, **kw)
        assert t.host_batch == j.host_batch == 8 // host_count
        states = []
        for _ in range(3):
            states.append(t.state())
            assert t.state() == j.state()
            jb, tb = j.next_batch(), t.next_batch()
            assert sorted(tb) == ["targets", "tokens"]
            for k in tb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        again = TData(host_index=host, **kw)
        again.restore(states[1])
        ref = JData(host_index=host, **kw)
        ref.restore(states[1])
        np.testing.assert_array_equal(again.next_batch()["tokens"],
                                      ref.next_batch()["tokens"])


def test_synthetic_lm_dataset_small_vocab_and_bad_host_count():
    """A vocab below n_topics * 16 (topic blocks clipped), and a global
    batch the hosts do not divide."""
    kw = dict(vocab=100, seq_len=16, global_batch=4, seed=3, step=5)
    np.testing.assert_array_equal(TData(**kw).next_batch()["tokens"],
                                  JData(**kw).next_batch()["tokens"])
    with pytest.raises(AssertionError):
        TData(vocab=100, seq_len=16, global_batch=6, host_count=4)


def test_train_lm_example_runs_on_cpu():
    """examples/train_lm_torch.py for a few steps on the CPU."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--steps", "3", "--seq-len", "32", "--global-batch", "2",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "config: 8L d=768 params=" in out
    assert "[train] done: 3 steps" in out
    assert "loss: " in out and "over 3 steps" in out
