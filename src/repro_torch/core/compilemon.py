"""Process-wide build-stall monitor: what stalls a flush while code builds.

The counterpart of ``repro/core/compilemon.py``, with its API
(``install``, ``snapshot``, ``since``, ``CompileSnapshot``,
``CompileDelta``).  The JAX package counts XLA backend compiles; the port
runs eagerly and never traces, so what stalls a flush in the same way is
the first use of a kernel: ``kernels/_build.py`` compiling a CUDA source
with nvcc, and loading the built library into the process.  Two monotone
counters:

  * ``n_compiles`` -- nvcc builds plus library loads (one event each);
  * ``stall_secs`` -- wall-clock seconds spent in them.

``_build`` reports each event through ``record``; the counters move only
after ``install()`` (idempotent), as in the JAX package, and consumers
read deltas::

    from repro_torch.core import compilemon
    compilemon.install()
    before = compilemon.snapshot()
    run_flush()
    d = compilemon.since(before)        # CompileDelta(n_compiles, stall_ms)

Interleaving contract (the JAX package's): the counters are
PROCESS-GLOBAL and MONOTONE, and a snapshot/since pair carries no
identity.  Two overlapping windows both count an event in their overlap
(``repro_torch.obs.region`` composes nested windows); a build on another
thread inside a window counts too; ``snapshot()`` is lock-consistent.
"""
from __future__ import annotations

import dataclasses
import threading

_lock = threading.Lock()
_installed = False
_n_compiles = 0
_stall_secs = 0.0


@dataclasses.dataclass(frozen=True)
class CompileSnapshot:
    """Monotone counters at one instant (see ``snapshot``)."""

    n_compiles: int
    stall_secs: float


@dataclasses.dataclass(frozen=True)
class CompileDelta:
    """Builds + stall time attributed to one region (see ``since``)."""

    n_compiles: int
    stall_ms: float


def record(events: int, duration_secs: float) -> None:
    """Count ``events`` builds or library loads that took
    ``duration_secs`` of wall clock (``kernels/_build.py`` calls this);
    dropped until ``install()`` has run."""
    global _n_compiles, _stall_secs
    with _lock:
        if not _installed:
            return
        _n_compiles += int(events)
        _stall_secs += float(duration_secs)


def install() -> None:
    """Start counting (idempotent, process-global)."""
    global _installed
    with _lock:
        _installed = True


def snapshot() -> CompileSnapshot:
    """Current monotone counters (0 until ``install()`` has run and a
    build has happened)."""
    with _lock:
        return CompileSnapshot(_n_compiles, _stall_secs)


def since(before: CompileSnapshot) -> CompileDelta:
    """Builds and stall milliseconds accumulated after ``before``."""
    now = snapshot()
    return CompileDelta(
        n_compiles=now.n_compiles - before.n_compiles,
        stall_ms=round((now.stall_secs - before.stall_secs) * 1e3, 3))
