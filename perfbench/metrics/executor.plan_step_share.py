"""Share of the lane-batched chunk steps, in %, that ran the full
scheduling stage: the program's ``executor.plan`` spans (the SecPE plan's
generation and reference cycles, on a step where some lane can still take
a plan or re-schedule) over the harness's count of chunk steps.  The rest are
settled steps, which skip that work.  A program without the stage reads
nothing."""
from perfbench.spans import chunk_steps, intervals


def read(trace):
    steps = chunk_steps(trace)
    plans = intervals(trace, "executor.plan")
    if steps is None or not len(plans):
        return None
    return 100.0 * len(plans) / steps
