"""Share of the traced window, in %, in which the device is idle while
the host is outside every ``executor.step`` span of the program: the idle
time that the engine's work around the steps (or the driver's) causes,
as against the gaps between one step's dispatched operations.  At most
``device_idle.stream``."""
import numpy as np

from perfbench.spans import chunk_steps, intervals, length


def read(trace):
    if chunk_steps(trace) is None or not len(trace.dev_start) or trace.window_s <= 0:
        return None
    steps = np.clip(intervals(trace, "executor.step"), 0.0, trace.window_s)
    covered = length(np.concatenate([trace.busy_intervals(), steps]))
    return 100.0 * (1.0 - covered / trace.window_s)
