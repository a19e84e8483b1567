"""Share of the traced window, in %, that the host spends in the
program's ``stream.drain`` spans, waiting for a batch's device work: near
0 while the host paces the steps, higher once the card does."""
from perfbench.spans import intervals, length


def read(trace):
    iv = intervals(trace, "stream.drain")
    if not len(iv) or trace.window_s <= 0:
        return None
    return 100.0 * length(iv) / trace.window_s
