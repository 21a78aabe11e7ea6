"""Preemption handling: SIGTERM -> checkpoint at the next step boundary.

The port's copy of ``repro.ft.preemption`` (stdlib only).

Cloud preemptions deliver a grace-period signal; the train loop
polls ``should_stop`` once per step and exits through a final checkpoint.
``install()`` is idempotent and chains any pre-existing handler.
"""
from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._signals = signals
        self._prev = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for sig in self._signals:
            self._prev[sig] = signal.getsignal(sig)
            signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()

    def request_stop(self) -> None:  # test hook / manual drain
        self._flag.set()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._installed = False
