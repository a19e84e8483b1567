"""Host ``aten::`` operations (nested ones counted) per lane-batched chunk
step of the stream engine, over the traced window: the host's dispatch
work a step, a count that repeats from run to run."""


def read(trace):
    steps = trace.work.get("chunk_steps")
    if not steps:
        return None
    return trace.aten_ops() / steps
