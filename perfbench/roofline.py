"""The bytes behind the chunk steps' roofline share, from the streams
alone, so that the share reads the same work whatever implements it.
Each input byte is counted read once and each output byte written once,
as the kernel table's counts in the port's smoke script count them
(``route_bound``).
"""
from __future__ import annotations


def chunk_step_bytes(tuples: int, cells: int, tuple_bytes: int = 8,
                     cell_bytes: int = 4) -> int:
    """Routed chunk steps: every valid tuple read once, and every PE buffer
    cell its tuples touch read and written once.  From the tuples, as the
    whole step takes them, a tuple is its 8 bytes (the PE kernel alone
    takes 12: its eff, idx and value).  ``cells`` counts the distinct
    (stream, bin) pairs of each step: the fewest cells the tuples can touch
    (a bin split over a PriPE and its SecPEs touches more)."""
    return tuples * tuple_bytes + 2 * cells * cell_bytes
