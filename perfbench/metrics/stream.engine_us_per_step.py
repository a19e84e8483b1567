"""The stream engine's own host time per lane-batched chunk step, in us:
the time inside the program's ``stream.batch`` spans that no
``executor.step`` or ``stream.drain`` span covers (stacking the streams,
their copy to the device, the stats' stacking, the merge, the copies
back), over the chunk steps."""
import numpy as np

from perfbench.spans import chunk_steps, intervals, length, overlap


def read(trace):
    steps = chunk_steps(trace)
    batches = intervals(trace, "stream.batch")
    if steps is None or not len(batches):
        return None
    inner = np.concatenate([intervals(trace, "executor.step"),
                            intervals(trace, "stream.drain")])
    return 1e6 * (length(batches) - overlap(batches, inner)) / steps
