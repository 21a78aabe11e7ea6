"""Deterministic, checkpointable synthetic LM data pipeline.

The port's copy of ``repro.data.pipeline`` (host numpy, no JAX): the same
tokens, bit for bit, for every (seed, host_index, host_count, step).

Tokens are a pure function of (seed, host, step) so that (a) every host
draws disjoint shards without coordination, (b) restoring ``state()`` after
a restart replays the exact stream, and (c) elastic restarts with a
different host count stay deterministic (the stream is keyed by global
batch index, not host-local counters).

A light Zipf mixture over "topic" blocks gives the stream enough structure
for the GSL-LPA locality clustering (``repro_torch.data.clustering``) to find
real communities in the doc-similarity graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 64
    host_index: int = 0
    host_count: int = 1
    step: int = 0

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.host_batch = self.global_batch // self.host_count

    # ------------------------------------------------------------ state ----
    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    # ------------------------------------------------------------- next ----
    def next_batch(self) -> dict:
        b, s = self.host_batch, self.seq_len
        tokens = np.zeros((b, s + 1), dtype=np.int32)
        for i in range(b):
            gidx = self.step * self.global_batch \
                + self.host_index * self.host_batch + i
            rng = np.random.default_rng((self.seed << 20) ^ gidx)
            topic = rng.integers(0, self.n_topics)
            # topic block: a contiguous slice of the vocab + shared commons
            lo = (self.vocab // self.n_topics) * topic
            hi = lo + max(self.vocab // self.n_topics, 16)
            topical = rng.integers(lo, min(hi, self.vocab), size=s + 1)
            common = rng.integers(0, min(1024, self.vocab), size=s + 1)
            pick = rng.random(s + 1) < 0.7
            tokens[i] = np.where(pick, topical, common)
        self.step += 1
        return {"tokens": tokens[:, :-1],
                "targets": tokens[:, 1:].astype(np.int32)}
