"""One traced window under ``torch.profiler``, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

``Window`` is the context manager a driver wraps around its traced work;
``Trace`` is what comes out: every device operation as an interval, the
host's operations as intervals and counts, the traced window's length, and
the driver's own ``work`` record (steps, shapes, counts) that the readers
turn into rates and roofline shares.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Trace:
    window_s: float
    # device operations (kernels, copies, sets): names and [start, end) in s
    dev_names: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    # host operations: names and [start, end) in s
    cpu_names: list
    cpu_start: np.ndarray
    cpu_end: np.ndarray
    cpu_counts: Counter
    work: dict = dataclasses.field(default_factory=dict)

    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint [n, 2] rows."""
        if not len(self.dev_start):
            return np.zeros((0, 2))
        order = np.argsort(self.dev_start)
        s = np.clip(self.dev_start[order], 0.0, self.window_s)
        e = np.clip(self.dev_end[order], 0.0, self.window_s)
        out = []
        cur_s, cur_e = s[0], e[0]
        for a, b in zip(s[1:], e[1:]):
            if a > cur_e:
                out.append((cur_s, cur_e))
                cur_s, cur_e = a, b
            elif b > cur_e:
                cur_e = b
        out.append((cur_s, cur_e))
        return np.asarray(out)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0

    def aten_ops(self) -> int:
        """Host ``aten::`` operations, nested ones counted."""
        return sum(c for n, c in self.cpu_counts.items() if n.startswith("aten::"))

    def top_device_ops(self, k: int = 10) -> list:
        tot: Counter = Counter()
        for n, a, b in zip(self.dev_names, self.dev_start, self.dev_end):
            tot[short_name(n)] += float(b - a)
        return [[n, s] for n, s in tot.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches of the window with no device
        operation, each named by the innermost host operation running at
        its middle."""
        iv = self.busy_intervals()
        edges = np.concatenate([[0.0], iv.reshape(-1), [self.window_s]]).reshape(-1, 2)
        gaps = [(float(b - a), float(a + b) / 2) for a, b in edges if b > a]
        gaps.sort(reverse=True)
        out = []
        for length, mid in gaps[:k]:
            covering = np.nonzero((self.cpu_start <= mid) & (self.cpu_end >= mid))[0]
            if len(covering):
                inner = covering[np.argmax(self.cpu_start[covering])]
                name = short_name(self.cpu_names[inner])
            else:
                name = "host (no traced operation)"
            out.append([name, length])
        return out


def idle_percent(trace: Trace, work_key: str):
    """The traced window's share with no device operation, in %, for a
    trace whose driver recorded ``work_key``; None otherwise, or where the
    device ran nothing."""
    if not trace.work.get(work_key) or not len(trace.dev_start):
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    base = name.split("(")[0]
    if base.startswith("void "):
        base = base[5:]
    return base.split("<")[0][:120] or name[:120]


class Window:
    """``with Window() as w: ...`` profiles the block (host and device);
    ``w.trace`` is then the reduced ``Trace``.  The block must end with the
    device synchronised, so that its last operations are in the window."""

    def __init__(self):
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self._prof.events(), window_s)
        return False


def reduce(events, window_s: float) -> Trace:
    """Profiler events -> ``Trace``; times relative to the first host
    event, which opens the window."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in events:
        (dev if e.device_type != DeviceType.CPU else cpu).append(e)
    # a host span (record_function) is mirrored on the device's timeline as
    # an annotation covering its kernels: it is no device operation
    spans = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    dev = [e for e in dev if not getattr(e, "is_user_annotation", False)
           and e.name not in spans]
    t0 = min((e.time_range.start for e in cpu), default=0.0)

    def arrays(evs):
        s = np.asarray([(e.time_range.start - t0) * 1e-6 for e in evs], np.float64)
        t = np.asarray([(e.time_range.end - t0) * 1e-6 for e in evs], np.float64)
        return s, t

    ds, de = arrays(dev)
    cs, ce = arrays(cpu)
    return Trace(window_s=window_s, dev_names=[e.name for e in dev], dev_start=ds,
                 dev_end=de, cpu_names=[e.name for e in cpu], cpu_start=cs, cpu_end=ce,
                 cpu_counts=Counter(e.name for e in cpu))
