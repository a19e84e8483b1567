"""Host time of the chunk step's routing stage (the program's
``executor.route`` spans: PrePE, mask, workload histogram, occurrence
rank, redirect) per lane-batched chunk step, in us."""
from perfbench.spans import us_per_step


def read(trace):
    return us_per_step(trace, "executor.route")
