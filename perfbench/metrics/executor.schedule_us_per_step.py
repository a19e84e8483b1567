"""Host time of the chunk step's scheduling stage (the program's
``executor.schedule`` spans: cycle model, profiler, SecPE scheduling and
plan, monitor, re-schedule, stats) per lane-batched chunk step, in us."""
from perfbench.spans import us_per_step


def read(trace):
    return us_per_step(trace, "executor.schedule")
