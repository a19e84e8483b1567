"""Input pipeline: chunked tuple streams for the Ditto executor and token
batches for LM training.

A copy of ``repro/data/pipeline.py`` (numpy only).  The executor scans
fixed-size chunks (the paper's profiling window / channel beat); with
``pad_tail=True`` the ragged tail becomes a masked final chunk that the
executor's validity-mask path treats as an exact no-op.  The training
half: ``write_corpus`` and ``ArrayRecordCorpus`` (a record-per-array file
with the array_record access contract; the same bytes as the JAX
package's, so either reads the other's files) and ``token_batches``
(deterministic synthetic LM batches, sharded by host).
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_CORPUS_MAGIC = b"DCRP\x01\x00\x00\x00"   # 8-byte file header: magic + v1
_CORPUS_FRAME = struct.Struct("<II")      # record length, crc32(record)
_CORPUS_HEAD = struct.Struct("<I")        # json header length


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


def write_corpus(path, records: Iterable[np.ndarray]) -> int:
    """Write a record-per-array corpus file; returns the record count.

    Layout: 8-byte magic, then per record ``[u32 len][u32 crc32(body)]``
    with ``body = [u32 hdr_len][JSON {"dtype","shape"}][C-order bytes]``
    -- the WAL frame, reused.  The file is written to a temp sibling and
    atomically renamed, so a corpus either exists whole or not at all
    (readers never see a torn tail; unlike the WAL there is no
    tolerant-truncation mode)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    n = 0
    with open(tmp, "wb") as f:
        f.write(_CORPUS_MAGIC)
        for a in records:
            a = np.ascontiguousarray(a)
            head = json.dumps({"dtype": a.dtype.str,
                               "shape": list(a.shape)},
                              separators=(",", ":")).encode()
            body = _CORPUS_HEAD.pack(len(head)) + head + a.tobytes()
            f.write(_CORPUS_FRAME.pack(len(body), zlib.crc32(body)) + body)
            n += 1
    tmp.replace(path)
    return n


class ArrayRecordCorpus:
    """File-backed record container with the array_record access
    contract: ``len(corpus)``, random-access ``corpus.read(indices)`` /
    ``corpus[i]``, and sequential ``iter(corpus)``.

    The offset index is built by one forward scan at open (frames are
    length-prefixed, so the scan reads headers only); records decode
    lazily on access and every access CRC-checks its frame -- a corrupt
    record raises ``ValueError`` instead of returning garbage."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        magic = self._f.read(len(_CORPUS_MAGIC))
        if magic != _CORPUS_MAGIC:
            raise ValueError(f"{self.path}: not a corpus file "
                             f"(magic {magic!r})")
        size = self.path.stat().st_size
        self._offsets: List[Tuple[int, int, int]] = []  # (off, len, crc)
        pos = len(_CORPUS_MAGIC)
        while pos < size:
            hdr = self._f.read(_CORPUS_FRAME.size)
            if len(hdr) < _CORPUS_FRAME.size:
                raise ValueError(f"{self.path}: torn frame header at "
                                 f"byte {pos}")
            blen, crc = _CORPUS_FRAME.unpack(hdr)
            body_off = pos + _CORPUS_FRAME.size
            if body_off + blen > size:
                raise ValueError(f"{self.path}: record at byte {pos} "
                                 f"overruns the file")
            self._offsets.append((body_off, blen, crc))
            pos = body_off + blen
            self._f.seek(pos)

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i: int) -> np.ndarray:
        off, blen, crc = self._offsets[i]
        self._f.seek(off)
        body = self._f.read(blen)
        if zlib.crc32(body) != crc:
            raise ValueError(f"{self.path}: record {i} failed its CRC")
        (hlen,) = _CORPUS_HEAD.unpack_from(body, 0)
        meta = json.loads(body[_CORPUS_HEAD.size:_CORPUS_HEAD.size + hlen])
        return np.frombuffer(
            body[_CORPUS_HEAD.size + hlen:],
            dtype=np.dtype(meta["dtype"])).reshape(meta["shape"]).copy()

    def read(self, indices: Sequence[int]) -> List[np.ndarray]:
        """Random-access batch read (the array_record idiom)."""
        return [self[int(i)] for i in indices]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "ArrayRecordCorpus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def token_batches(global_batch: int, seq_len: int, vocab: int,
                  num_hosts: int = 1, host_id: int = 0,
                  seed: int = 0) -> Iterator[dict]:
    """Deterministic synthetic LM batches, sharded by host.

    Yields {'tokens': [B_host, S] int32, 'targets': [B_host, S] int32}.
    Targets are tokens shifted by one (next-token LM).  Deterministic in
    (seed, step, host) so restarts resume bit-identically mid-epoch -- the
    property elastic checkpoint-restore relies on.
    """
    assert global_batch % num_hosts == 0
    b_host = global_batch // num_hosts
    step = 0
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id]))
        toks = rng.integers(0, vocab, size=(b_host, seq_len + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        step += 1
