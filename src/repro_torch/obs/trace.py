"""Span tracer: contextvar-nested wall-time spans + Chrome-trace export.

A ContextVar carries the current span, so nested stages parent correctly
across threads and concurrent engines.  Spans wrap host-side stage
boundaries only (engine prepare / dispatch / compact, batcher dispatch /
settle) and are read on the host clock; where a stage ends with a device
synchronize (the engine's timed stages do), the span includes the device
work.  No span enters a sweep loop.

Export is the Chrome trace-event JSON array (``chrome://tracing`` /
Perfetto): complete events (``"ph": "X"``) with microsecond timestamps
relative to tracer start, ``tid`` = OS thread ident so concurrent
request lanes render as parallel tracks.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any

_MAX_SPANS = 65536  # bounded history: long servers drop oldest spans

_CURRENT: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("repro_torch_current_span", default=None)

_ids = itertools.count(1)


@dataclasses.dataclass
class Span:
    """One finished (or in-flight) wall-time interval."""
    name: str
    t0: float                      # perf_counter at enter
    dur: float = 0.0               # seconds; 0.0 while in flight
    span_id: int = 0
    parent_id: int = 0             # 0 = root
    tid: int = 0                   # OS thread ident
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, **attrs) -> "Span":
        """Attach attributes after enter (counts known only at exit)."""
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Returned when tracing is disabled — absorbs ``.set()`` for free."""
    __slots__ = ()

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class Tracer:
    """Bounded in-memory span recorder with a Chrome-trace exporter."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=_MAX_SPANS)
        self._epoch = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield _NULL
            return
        parent = _CURRENT.get()
        s = Span(name=name, t0=time.perf_counter(), span_id=next(_ids),
                 parent_id=parent.span_id if parent else 0,
                 tid=threading.get_ident(), attrs=dict(attrs))
        token = _CURRENT.set(s)
        try:
            yield s
        finally:
            _CURRENT.reset(token)
            s.dur = time.perf_counter() - s.t0
            with self._lock:
                self._spans.append(s)

    def current(self) -> Span | None:
        return _CURRENT.get()

    def spans(self, prefix: str = "") -> list[Span]:
        with self._lock:
            return [s for s in self._spans if s.name.startswith(prefix)]

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
        self._epoch = time.perf_counter()

    def chrome_trace(self) -> list[dict]:
        """Trace-event list: complete (``ph:"X"``) events, µs timebase."""
        pid = os.getpid()
        with self._lock:
            spans = list(self._spans)
        events = []
        for s in spans:
            args = {k: v for k, v in s.attrs.items()}
            if s.parent_id:
                args["parent_span"] = s.parent_id
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": round((s.t0 - self._epoch) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "args": args,
            })
        return events

    def export_chrome(self, path) -> int:
        """Write the Chrome-trace JSON array; returns the event count."""
        events = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(events, fh)
        return len(events)


# Process-global tracer.  ``span("engine.fit")`` is the one-liner every
# stage boundary uses; disable with ``TRACER.enabled = False`` (spans
# then cost one attribute read and an empty yield).
TRACER = Tracer()
span = TRACER.span
