"""The routed chunk steps' share of their roofline, in %: the least time
their data needs at the HBM peak (each valid tuple read once, each PE
buffer cell it touches read and written once, ``roofline.chunk_step_bytes``)
over the device's busy time in the traced window, which holds nothing but
those steps and the flushes' copies."""
from perfbench import peaks, roofline


def read(trace):
    w = trace.work
    if not w.get("chunk_steps"):
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    nbytes = roofline.chunk_step_bytes(w["tuples"], w["cells"], w["tuple_bytes"])
    return 100.0 * nbytes / peaks.H100["hbm_bytes_per_s"] / busy
