"""Search space of the perfmodel-guided autotuner.

The paper fixes everything but X: M comes from the Eq. 1 balance, and the
chunk size is the profiling-window granularity.  The tuner re-opens both:

  * ``m_candidates`` -- PriPE counts around the Eq. 1 balanced point M*
                        (halving under-provisions the II bound, doubling
                        buys nothing once the port bound dominates);
  * ``chunk_sizes``  -- profiling-window sizes.  The port-limited cycle
                        model does not depend on them, so the measured pass
                        decides between them.

There is no kernel-realization axis: the tensor's device picks the
realization (the kernel on the card, the plain version on the CPU).  X is
not enumerated here either: per (M, workload) the Eq. 2 analyzer gives the
candidate, and the tuner checks it against X = 0 and X = M-1 (tuner.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One fully specified configuration point."""

    num_pri: int
    num_sec: int
    chunk_size: int


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The axes the tuner explores (see the module docstring)."""

    m_candidates: tuple
    chunk_sizes: tuple = (4096,)

    def __post_init__(self):
        if not self.m_candidates:
            raise ValueError("m_candidates must be non-empty")
        if any(m < 1 for m in self.m_candidates):
            raise ValueError(f"PriPE counts must be >= 1: {self.m_candidates}")
        if not self.chunk_sizes:
            raise ValueError("chunk_sizes must be non-empty")


def default_space(m_star: int, *, search_m: bool = True,
                  chunk_sizes: Sequence[int] = (4096,)) -> SearchSpace:
    """The default neighbourhood of the Eq. 1 balanced point ``m_star``."""
    if search_m:
        ms = tuple(sorted({max(2, m_star // 2), m_star, 2 * m_star}))
    else:
        ms = (m_star,)
    return SearchSpace(m_candidates=ms, chunk_sizes=tuple(chunk_sizes))
