"""Share of the traced window, in %, in which no operation ran on the
device (the union of the profiler's device intervals)."""
from perfbench.trace import idle_percent


def read(trace):
    return idle_percent(trace, "chunk_steps")
