"""Host time of the chunk step's PE buffer update (the program's
``executor.pe_update`` spans: one ``route_accumulate`` launch for all
lanes on the card) per lane-batched chunk step, in us."""
from perfbench.spans import us_per_step


def read(trace):
    return us_per_step(trace, "executor.pe_update")
