"""GSL-LPA applied to the data pipeline: locality-aware batch clustering.

The counterpart of ``repro.data.clustering``: builds a document-similarity
graph (vocab-block overlap) over a corpus shard on the host and runs the
paper's algorithm (``core.gsl_lpa``) to group related documents.  The
no-internally-disconnected-communities guarantee matters here: a
disconnected "community" would merge unrelated documents into one bucket.
``device`` is where the detection runs (``None``: CUDA); the graph is built
on the host either way.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import build_graph, gsl_lpa

__all__ = ["cluster_documents", "doc_similarity_graph", "locality_batches"]


def doc_similarity_graph(docs: np.ndarray, n_hash_buckets: int = 512,
                         min_shared: int = 2):
    """docs: (n_docs, seq) int tokens -> similarity Graph (on the host).

    Two documents are connected with weight = #shared vocab buckets when
    they share >= min_shared buckets and more than a quarter of the
    smaller signature.  Buckets quantise the vocab range (not modulo,
    which would alias distinct vocab blocks onto the same buckets).
    """
    n = docs.shape[0]
    vmax = max(int(docs.max()) + 1, n_hash_buckets)
    sigs = [set((np.unique(d) * n_hash_buckets // vmax).tolist())
            for d in docs]
    edges, weights = [], []
    for i in range(n):
        for j in range(i + 1, n):
            shared = len(sigs[i] & sigs[j])
            denom = min(len(sigs[i]), len(sigs[j])) or 1
            if shared >= min_shared and shared / denom > 0.25:
                edges.append((i, j))
                weights.append(float(shared))
    if not edges:
        edges, weights = [(0, min(1, n - 1))], [1e-6]
    return build_graph(np.array(edges), np.array(weights), n=n)


def cluster_documents(docs: np.ndarray, device=None, **lpa_kw) -> np.ndarray:
    """Community label per document (GSL-LPA: guaranteed connected)."""
    g = doc_similarity_graph(docs)
    res = gsl_lpa(g, split=lpa_kw.pop("split", "lp"), device=device,
                  **lpa_kw)
    return res.labels


def locality_batches(docs: np.ndarray, batch_size: int,
                     device=None) -> list[np.ndarray]:
    """Greedy community-contiguous batch index lists."""
    labels = cluster_documents(docs, device=device)
    order = np.argsort(labels, kind="stable")
    return [order[i:i + batch_size]
            for i in range(0, len(order), batch_size)]
