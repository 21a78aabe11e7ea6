"""Streaming re-detection sessions over evolving graphs.

A :class:`StreamSession` tracks named *streams*, graphs that evolve by
:class:`repro_torch.core.delta.GraphDelta` updates, and serves their
re-detections through a :class:`MicroBatcher`: concurrent updates coalesce
into one ``Engine.fit_many`` dispatch, each member warm-started from its
stream's previous labels with the delta's affected frontier seeded
unprocessed.  Each member equals a solo warm ``fit`` of its stream, so
batching and warm starts change latency, never results.

    eng = Engine(EngineConfig())
    with StreamSession(eng) as sess:
        sess.add("social", g0)                      # cold first detection
        res = sess.update("social", delta)          # warm re-detection
        out = sess.update_many({"a": d1, "b": d2})  # one batched dispatch
    print(sess.stats())

A stream's graph stays on the host between updates (the delta code is host
numpy); the engine moves it to its device for each fit.  ``warm=False``
re-detects every update cold, still batched: the baseline a warm session
is compared with.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.delta import (
    GraphDelta,
    affected_frontier,
    apply_delta,
    apply_delta_patch,
)
from repro_torch.core.graph import Graph
from repro_torch.launch.microbatch import MicroBatcher, Submission


@dataclasses.dataclass
class StreamState:
    """A stream's current graph (on the host) and its last labels."""
    graph: Graph
    labels: np.ndarray | None = None  # compacted [0, K); None before 1st fit
    version: int = 0                  # deltas applied so far
    splice_seconds: float = 0.0       # host time of the last delta's splice


@dataclasses.dataclass
class PreparedUpdate:
    """One stream's post-delta graph and resolved warm state, not yet
    dispatched or committed.  ``StreamSession.prepare_update`` builds it
    and ``commit_update`` applies it after the fit succeeds; a serving
    tier may drive the two halves from different threads, ``update_many``
    runs them back to back."""
    graph: Graph
    init_labels: np.ndarray | None
    init_active: np.ndarray | None
    frontier_frac: float | None  # None when no frontier seed was built
    splice_seconds: float = 0.0  # host time of apply_delta(_patch)


class StreamUpdateError(RuntimeError):
    """Some members of an ``update_many`` batch failed.

    Every successful member is committed (graph, labels, counters) before
    this raises; a failed stream keeps its pre-delta state, so a retry
    re-applies the same delta.  ``results`` holds the committed
    ``{stream_id: DetectionResult}``, ``errors`` each failed stream's
    exception.
    """

    def __init__(self, errors: dict, results: dict):
        self.errors = errors
        self.results = results
        detail = "; ".join(f"{sid!r}: {type(e).__name__}: {e}"
                           for sid, e in errors.items())
        super().__init__(
            f"{len(errors)} of {len(errors) + len(results)} stream "
            f"updates failed ({detail}); {len(results)} committed")


class StreamSession:
    """Batched warm re-detection over named evolving-graph streams.

    engine: the :class:`repro_torch.engine.Engine` serving the session.
    warm: warm-start each update from its stream's previous labels
      (``False``: a cold re-detection per update, the baseline).
    frontier: also seed only the delta's affected frontier unprocessed
      (needs ``warm``).
    max_batch / batch_timeout_ms / backend: the micro-batcher's knobs; or
      pass a ``batcher`` to share one scheduler between sessions.
    """

    def __init__(self, engine, *, warm: bool = True, frontier: bool = True,
                 max_batch: int = 16, batch_timeout_ms: float = 2.0,
                 backend: str | None = None,
                 batcher: MicroBatcher | None = None):
        self.engine = engine
        self.warm = warm
        self.frontier = frontier and warm
        self._own_batcher = batcher is None
        self.batcher = batcher if batcher is not None else MicroBatcher(
            engine, max_batch=max_batch, batch_timeout_ms=batch_timeout_ms,
            backend=backend)
        self.streams: dict = {}
        self.updates = 0        # delta updates served
        self.warm_updates = 0   # ... of which warm-started
        self._frontier_fracs: list[float] = []

    # --- lifecycle ---

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._own_batcher:
            self.batcher.close()

    # --- stream registration ---

    def add(self, stream_id, graph: Graph):
        """Register a stream with its first graph; a cold first fit."""
        return self.add_many({stream_id: graph})[stream_id]

    def add_many(self, graphs: dict) -> dict:
        """Register several streams at once (one coalesced dispatch)."""
        for sid in graphs:
            if sid in self.streams:
                raise ValueError(f"stream {sid!r} already registered")
        graphs = {sid: g.to("cpu") for sid, g in graphs.items()}
        subs = {sid: self.batcher.submit(g) for sid, g in graphs.items()}
        return self._settle(graphs, subs)

    def graph(self, stream_id) -> Graph:
        return self.streams[stream_id].graph

    def labels(self, stream_id) -> np.ndarray | None:
        return self.streams[stream_id].labels

    # --- delta updates ---

    def update(self, stream_id, delta: GraphDelta):
        """Apply one delta and re-detect (through the shared batcher)."""
        return self.update_many({stream_id: delta})[stream_id]

    def update_many(self, deltas: dict) -> dict:
        """Apply a delta per stream and re-detect them as one batch.

        The updates are submitted as one burst after all the host delta
        work, so up to ``max_batch`` of them ride one ``fit_many``.
        Returns ``{stream_id: DetectionResult}``.  Settlement is per
        stream: a failed member raises :class:`StreamUpdateError` after
        every successful sibling is committed, and keeps its pre-delta
        state.
        """
        preps = {sid: self.prepare_update(sid, delta)
                 for sid, delta in deltas.items()}
        subs = {sid: self.batcher.submit(p.graph, init_labels=p.init_labels,
                                         init_active=p.init_active)
                for sid, p in preps.items()}
        return self._settle(preps, subs)

    def prepare_update(self, sid, delta: GraphDelta) -> PreparedUpdate:
        """One stream's post-delta graph and warm state, session state
        untouched (it is committed after the fit succeeds).

        A delta that touches fewer than ``patch_churn_threshold`` of the
        vertices is spliced in (``apply_delta_patch``), a heavier one
        rebuilds the CSR (``apply_delta``); both give the same bytes.
        """
        st = self.streams[sid]
        threshold = self.engine.config.patch_churn_threshold
        patched = len(delta.touched_vertices()) \
            < threshold * max(st.graph.n, 1)
        t0 = time.perf_counter()
        post = (apply_delta_patch if patched else apply_delta)(st.graph,
                                                               delta)
        splice = time.perf_counter() - t0
        init = act = frac = None
        if self.warm and st.labels is not None:
            init = st.labels
            if post.n > len(init):  # grown: new vertices start singleton
                init = np.concatenate([
                    init, np.arange(len(init), post.n, dtype=np.int32)])
            if self.frontier:
                act = affected_frontier(delta, post.n)
                frac = float(act.sum()) / max(post.n, 1)
        return PreparedUpdate(graph=post, init_labels=init, init_active=act,
                              frontier_frac=frac, splice_seconds=splice)

    def commit_update(self, sid, prep: PreparedUpdate, res) -> None:
        """Commit one successful member: its state and the counters, after
        the fit, so a failed sibling leaves no count behind."""
        st = self.streams.get(sid)
        if st is None:
            st = self.streams[sid] = StreamState(graph=prep.graph)
        else:
            st.graph = prep.graph
            st.version += 1
        st.labels = res.labels
        st.splice_seconds = prep.splice_seconds
        self.updates += 1
        self.warm_updates += bool(res.warm_started)
        if prep.frontier_frac is not None:
            self._frontier_fracs.append(prep.frontier_frac)

    def _settle(self, preps: dict, subs: dict[object, Submission]) -> dict:
        """Commit every success, then raise the failures together."""
        results: dict = {}
        errors: dict = {}
        for sid, sub in subs.items():
            try:
                res = sub.result()
            except Exception as e:  # one member's failure, kept per stream
                errors[sid] = e
                continue
            prep = preps[sid]
            if isinstance(prep, PreparedUpdate):
                self.commit_update(sid, prep, res)
            else:  # add_many: a first graph, not a counted update
                self.streams[sid] = StreamState(graph=prep, labels=res.labels)
            results[sid] = res
        if errors:
            raise StreamUpdateError(errors, results)
        return results

    # --- observability ---

    def stats(self) -> dict:
        """Session counters and the batcher's serving stats."""
        fr = self._frontier_fracs
        return {
            **self.batcher.stats(),
            "streams": len(self.streams),
            "updates": self.updates,
            "warm_updates": self.warm_updates,
            "mean_frontier_frac": float(np.mean(fr)) if fr else 0.0,
        }
