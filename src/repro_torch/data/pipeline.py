"""Chunked tuple streams for the Ditto executor.

A copy of ``TupleStream``, ``chunk_stream`` and ``pad_tail_chunk`` from
``repro/data/pipeline.py`` (numpy only).  The executor scans fixed-size
chunks (the paper's profiling window / channel beat); with
``pad_tail=True`` the ragged tail becomes a masked final chunk that the
executor's validity-mask path treats as an exact no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TupleStream:
    """Chunked stream: body [num_chunks, chunk, ...] plus either a raw
    ragged tail (``pad_tail=False``) or a validity mask covering a padded
    final chunk (``pad_tail=True``, the executor-ready form)."""

    body: np.ndarray            # [num_chunks, chunk_size, ...]
    tail: Optional[np.ndarray]  # [tail_len, ...] or None
    chunk_size: int
    mask: Optional[np.ndarray] = None  # bool[num_chunks, chunk_size] or None

    @property
    def num_tuples(self) -> int:
        if self.mask is not None:
            return int(self.mask.sum())
        n = self.body.shape[0] * self.body.shape[1]
        return n + (len(self.tail) if self.tail is not None else 0)


def chunk_stream(data: np.ndarray, chunk_size: int, *,
                 pad_tail: bool = False, pad_key: int = 0) -> TupleStream:
    """Split a flat [n, ...] stream into executor chunks.

    pad_tail=False: exact-multiple ``body`` plus the raw ``tail`` (legacy
    shape; callers hand-roll the tail).  pad_tail=True: the tail is padded
    into a masked final chunk and ``mask`` (bool[num_chunks, chunk_size])
    marks the real tuples -- feed ``(body, mask)`` straight to
    ``make_executor(...)(body, mask=mask)`` and padding is an exact no-op
    (core.executor's validity-mask path).

    Empty-stream contract (``len(data) == 0``, ``pad_tail=True``): the
    result is a ZERO-chunk stream, not a single all-masked chunk --
    ``body`` has shape ``[0, chunk_size, ...]``, ``mask`` has shape
    ``[0, chunk_size]`` and ``num_tuples == 0``; running zero chunks
    leaves an executor state untouched, so empty streams need no
    special-casing.  With ``pad_tail=False`` the same input yields an
    empty ``body`` and ``tail=None``."""
    data = np.asarray(data)
    n = len(data)
    body_len = (n // chunk_size) * chunk_size
    body = data[:body_len].reshape(-1, chunk_size, *data.shape[1:])
    tail = data[body_len:] if body_len < n else None
    if not pad_tail:
        return TupleStream(body=body, tail=tail, chunk_size=chunk_size)
    mask = np.ones((body.shape[0], chunk_size), bool)
    if tail is not None:
        padded, tail_mask = pad_tail_chunk(tail, chunk_size, pad_key)
        body = np.concatenate([body, padded[None]], axis=0)
        mask = np.concatenate([mask, tail_mask[None]], axis=0)
    return TupleStream(body=body, tail=None, chunk_size=chunk_size, mask=mask)


def pad_tail_chunk(tail: np.ndarray, chunk_size: int,
                   pad_key: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad the tail to one full chunk; mask marks real tuples.  The
    executor routes masked tuples to sentinel PEs that every update drops."""
    pad = chunk_size - len(tail)
    mask = np.concatenate([np.ones(len(tail), bool), np.zeros(pad, bool)])
    padded = np.concatenate(
        [tail, np.full((pad, *tail.shape[1:]), pad_key, tail.dtype)], axis=0)
    return padded, mask
