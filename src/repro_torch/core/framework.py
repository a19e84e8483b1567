"""The Ditto framework front-end (paper §V, Fig. 6).

Workflow: the developer writes a ``DittoSpec``; ``tune_pe_counts`` balances
the pipeline (Eq. 1); ``generate`` builds the family of implementations
X = 0..M-1; ``build`` samples the dataset, runs the skew analyzer (Eq. 2)
and returns the selected implementation; ``tune`` searches X and the chunk
size with the autotuner (``repro_torch.tune``).  Every implementation runs on the
framework's ``device`` ("cuda" by default, which raises without a CUDA
device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import analyzer, executor
from repro_torch.core.types import DittoSpec, resolve_device
from repro_torch.data.pipeline import chunk_stream


def tune_pe_counts(mem_width_bytes: int, tuple_bytes: int, ii_pre: int,
                   ii_pe: int) -> tuple[int, int, int]:
    """Eq. 1: returns (N_PrePE, N_PriPE, W tuples/cycle)."""
    w = mem_width_bytes // tuple_bytes
    return w * ii_pre, w * ii_pe, w


@dataclasses.dataclass(frozen=True)
class GeneratedImpl:
    """One point of the generated family: an executor with X SecPEs.
    ``run(chunks, plan=None, mask=None) -> (merged, ExecStats)`` executes
    one chunk stream; ``run_streams(tuples, plans=None, mask=None)`` runs
    [num_streams, num_chunks, chunk, ...] as lanes of one batched step, with
    a leading streams axis on every output and a profiler and plan a
    stream."""

    num_pri: int
    num_sec: int
    run: Callable[..., Any]
    run_streams: Optional[Callable[..., Any]] = None

    @property
    def buffer_capacity_fraction(self) -> float:
        return analyzer.buffer_capacity_fraction(self.num_pri, self.num_sec)


class Ditto:
    """Framework object tying spec -> generation -> selection together."""

    def __init__(self, spec: DittoSpec, *, mem_width_bytes: int = 64,
                 chunk_size: int = 4096, profile_chunks: int = 1,
                 threshold: float = 0.0, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.mem_width_bytes = mem_width_bytes
        n_pre, n_pri, w = tune_pe_counts(mem_width_bytes, spec.tuple_bytes,
                                         spec.ii_pre, spec.ii_pe)
        self.num_pre = n_pre
        self.num_pri = n_pri
        self.mem_width_tuples = w
        self.chunk_size = chunk_size
        self.profile_chunks = profile_chunks
        self.threshold = threshold

    def generate(self, xs: Optional[Sequence[int]] = None) -> list[GeneratedImpl]:
        """Implementation variants X = 0..M-1 (paper §V-C)."""
        xs = range(self.num_pri) if xs is None else xs
        kw = dict(profile_chunks=self.profile_chunks, threshold=self.threshold,
                  mem_width_tuples=self.mem_width_tuples, device=self.device)
        return [GeneratedImpl(
            self.num_pri, x,
            executor.make_executor(self.spec, self.num_pri, x, self.chunk_size, **kw),
            executor.make_multistream_executor(self.spec, self.num_pri, x,
                                               self.chunk_size, **kw))
            for x in xs]

    def select(self, keys: np.ndarray, tolerance: float = 0.01,
               online: bool = False, sample_frac: float = 0.001) -> int:
        """Skew analyzer: sample -> Eq. 2 -> X (paper §V-D)."""
        if online:
            return self.num_pri - 1
        sample = analyzer.sample_dataset(np.asarray(keys), frac=sample_frac)
        if sample.ndim == 1:          # bare keys -> single-column tuples
            sample = sample[:, None]
        dst, _, _ = self.spec.pre(torch.as_tensor(sample, device=self.device),
                                  self.num_pri)
        return analyzer.select_implementation(dst, self.num_pri, tolerance)

    def build(self, keys: np.ndarray, tolerance: float = 0.01,
              online: bool = False) -> GeneratedImpl:
        x = self.select(keys, tolerance=tolerance, online=online)
        return self.generate([x])[0]

    def tune(self, keys: np.ndarray, *, tolerance: float = 0.1,
             sample_frac: float = 0.001, measure: bool = False,
             chunk_sizes: Optional[Sequence[int]] = None, **kw):
        """Perfmodel-guided autotune at this framework's M, on its device.

        ``select`` is the paper's Eq. 2 X pick alone; ``tune`` also checks it
        against the X extremes with the port-limited cycle model and, with
        ``measure``, picks among ``chunk_sizes`` (default: this framework's
        chunk size) by measured wall clock.  ``kw`` goes to
        ``repro_torch.tune.autotune``.  Returns a ``TunedPlan`` that
        ``make_executor`` takes in place of ``num_pri``.
        """
        from repro_torch.tune import SearchSpace, autotune
        sample = analyzer.sample_dataset(np.asarray(keys), frac=sample_frac)
        space = SearchSpace(m_candidates=(self.num_pri,),
                            chunk_sizes=tuple(chunk_sizes or (self.chunk_size,)))
        return autotune(self.spec, sample, mem_width_bytes=self.mem_width_bytes,
                        space=space, tolerance=tolerance, measure=measure,
                        device=self.device, **kw)

    def chunk(self, data: np.ndarray) -> torch.Tensor:
        """A flat stream whose length is a multiple of the chunk size ->
        [num_chunks, chunk_size, ...] on the device.  Ragged streams go
        through ``chunk_masked``."""
        n, c = len(data), self.chunk_size
        if n % c:
            raise ValueError(f"stream length {n} not a multiple of chunk {c}; "
                             "use Ditto.chunk_masked for ragged input")
        return torch.as_tensor(np.asarray(data).reshape(-1, c, *data.shape[1:]),
                               device=self.device)

    def chunk_masked(self, data: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Any-length stream -> (chunks, mask) on the device; pass both to
        ``run(chunks, mask=mask)`` and the padding is an exact no-op."""
        ts = chunk_stream(np.asarray(data), self.chunk_size, pad_tail=True)
        return (torch.as_tensor(ts.body, device=self.device),
                torch.as_tensor(ts.mask, device=self.device))
