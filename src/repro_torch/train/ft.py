"""Fault-tolerance plumbing: preemption handling and straggler telemetry.

A copy of ``repro/train/ft.py`` (pure Python).  At fleet scale any step can
be the last (SIGTERM from the scheduler, hardware loss), and some hosts run
slow before they fail.  The answers here: checkpoint-and-exit on a signal
(the owner polls ``PreemptionGuard.preempted``), and step-time telemetry
that flags stragglers by z-score.  The serving layer's durable engine
(``serve.DurableSessionEngine``) takes the guard as ``guard=``.
"""
from __future__ import annotations

import collections
import math
import signal
import threading
from typing import Optional


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set a flag instead of killing
    the process mid-step.  Safe to instantiate in non-main threads (no-op
    installation there -- tests).

    Consumers poll ``preempted`` at a step boundary: the train loop
    checkpoints and exits, and the serving layer's durable engine
    (``serve.DurableSessionEngine``) runs its drain-and-checkpoint path
    (flush open sessions, blocking checkpoint, release the WAL) before
    refusing further work.  ``uninstall()`` restores the
    previous handlers once the guard's owner has drained."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        if threading.current_thread() is threading.main_thread():
            for s in signals:
                try:
                    self._prev[s] = signal.signal(s, self._handler)
                except (ValueError, OSError):
                    pass

    def _handler(self, signum, frame):
        self._flag.set()

    def trigger(self):     # tests / manual drain
        self._flag.set()

    def uninstall(self):
        """Restore the signal handlers that were active before this guard
        (called by the drain path once its owner is durable on disk)."""
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


class StepTelemetry:
    """Sliding-window step-time stats; flags straggling steps by z-score.

    On a real fleet this runs per-host and the controller compares hosts;
    here it is the single-process skeleton with the same interface."""

    def __init__(self, window: int = 64, z_thresh: float = 3.0):
        self.times = collections.deque(maxlen=window)
        self.z_thresh = z_thresh
        self.flagged = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler vs the window."""
        is_straggler = False
        if len(self.times) >= 8:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            sd = math.sqrt(var)
            # sd==0 (perfectly steady pipeline) still must flag a blowup:
            # fall back to a relative threshold
            if (sd > 0 and (dt - mean) / sd > self.z_thresh) or \
                    (sd == 0 and dt > 1.5 * mean):
                is_straggler = True
                self.flagged += 1
        self.times.append(dt)
        return is_straggler

    @property
    def mean(self) -> Optional[float]:
        return sum(self.times) / len(self.times) if self.times else None
