"""The program's own spans in a traced window: the host ranges that
``repro_torch``'s tracer opens under the profiler (``executor.step``,
``stream.batch``, ...), as intervals of the ``Trace``'s host events.

A program without such spans gives no intervals, and the readers built on
these helpers then read nothing (None), as for any trace that lacks what
they read.
"""
from __future__ import annotations

import numpy as np

STEP = "executor.step"


def intervals(trace, name: str) -> np.ndarray:
    """The host events named ``name``, as [n, 2] rows of [start, end) in s."""
    pick = np.asarray([n == name for n in trace.cpu_names], bool)
    if not pick.any():
        return np.zeros((0, 2))
    return np.stack([trace.cpu_start[pick], trace.cpu_end[pick]], axis=1)


def union(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint [m, 2] rows covering the rows of ``iv``."""
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a > out[-1][1]:
            out.append([a, b])
        elif b > out[-1][1]:
            out[-1][1] = b
    return np.asarray(out)


def length(iv: np.ndarray) -> float:
    """The total length of ``iv``'s union."""
    u = union(iv)
    return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """The length of the part of ``a``'s union that ``b``'s union covers."""
    ua, ub = union(a), union(b)
    total, j = 0.0, 0
    for s, e in ua:
        while j < len(ub) and ub[j, 1] <= s:
            j += 1
        k = j
        while k < len(ub) and ub[k, 0] < e:
            total += min(e, ub[k, 1]) - max(s, ub[k, 0])
            k += 1
    return total


def chunk_steps(trace):
    """The driver's count of chunk steps, where the window holds exactly
    that many ``executor.step`` spans; None otherwise (no spans, or spans
    that are not one a step)."""
    steps = trace.work.get("chunk_steps")
    if not steps or len(intervals(trace, STEP)) != steps:
        return None
    return steps


def us_per_step(trace, name: str):
    """The summed time of the spans ``name`` per chunk step, in us."""
    steps = chunk_steps(trace)
    iv = intervals(trace, name)
    if steps is None or not len(iv):
        return None
    return 1e6 * float((iv[:, 1] - iv[:, 0]).sum()) / steps
