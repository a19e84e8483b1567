"""DP -- data partitioning with a radix hash (paper Table I, [17][18]).

The *non-decomposable* application: a PE's state is an append-only output
region, not a commutative accumulator, so "PrePEs and SecPEs output results
to their own memory space of the global memory" (paper §IV-B) and the merge
keeps the regions apart; the host reads the partitions out of them at the
end (``partitions_from_buffers``).  The spec therefore brings its own
``pe_update`` (cursor append) and ``merge``.  Neither is a TPU kernel in the
JAX package, so both stay plain PyTorch on every device.

The partition of key k is its low ``radix_bits`` bits; partition p is owned
by PriPE p % M.  With a fan-out above M each PE holds several partitions
(Table II's fan-out per buffer), none replicated across PEs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps.hashes import radix, radix_np
from repro_torch.core.types import DittoSpec, RoutePlan


@dataclasses.dataclass(frozen=True)
class DPBuffers:
    """Per-PE output regions and write cursors, all int32."""

    out: torch.Tensor       # [num_pe, capacity, 2] appended tuples
    cursor: torch.Tensor    # [num_pe] tuples appended so far
    dst_part: torch.Tensor  # [num_pe, capacity] partition id of each slot, -1 free


def make_spec(radix_bits: int, num_pri: int, capacity_per_pe: int) -> DittoSpec:
    """DP spec: each PE appends its tuples to a region of
    ``capacity_per_pe`` slots.  A region that fills up keeps writing its
    last slot (so duplicate writes there have no defined order, as in the
    JAX package): size the capacity above the busiest PE's tuple count."""

    def pre(chunk, num_pri_):
        part = radix(chunk[..., 0], radix_bits)
        # idx carries the partition id, value the tuple row itself
        return (part % num_pri_).to(torch.int32), part, chunk

    def init_buffer(num_pe, device):
        return DPBuffers(
            out=torch.zeros((num_pe, capacity_per_pe, 2), dtype=torch.int32,
                            device=device),
            cursor=torch.zeros((num_pe,), dtype=torch.int32, device=device),
            dst_part=torch.full((num_pe, capacity_per_pe), -1, dtype=torch.int32,
                                device=device))

    def pe_update(bufs: DPBuffers, eff, idx, value):
        """Append each tuple at its effective PE's cursor, in stream order;
        writes ``out`` and ``dst_part`` in place.  A tuple whose eff lies
        outside [0, num_pe) (the executor's masked sentinel) is dropped.
        Lanes-stacked buffers ([L, num_pe, ...]) take eff [L, T], idx
        [L, T] and value [L, T, 2]: each lane appends to its own regions."""
        if eff.dim() == 1:
            one = pe_update(DPBuffers(out=bufs.out[None], cursor=bufs.cursor[None],
                                      dst_part=bufs.dst_part[None]),
                            eff[None], idx[None], value[None])
            return DPBuffers(out=bufs.out, cursor=one.cursor[0], dst_part=bufs.dst_part)
        lanes, t = eff.shape
        num_pe, cap = bufs.out.shape[1:3]
        pes = torch.arange(num_pe, dtype=eff.dtype, device=eff.device)
        # the rank of each tuple within its PE's sub-stream of this chunk,
        # scanned along the last axis of a per-lane [L, num_pe, T] one-hot
        onehot = (eff[:, None, :] == pes[None, :, None]).to(torch.int32)
        incl = torch.cumsum(onehot, dim=2, dtype=torch.int32)
        cursor = bufs.cursor + incl[:, :, -1]
        kept = (eff >= 0) & (eff < num_pe)
        e = eff.clamp(0, num_pe - 1).long()
        lane = torch.arange(lanes, device=eff.device)[:, None].expand(lanes, t)
        rank = (incl - onehot).gather(1, e[:, None, :])[:, 0]
        slot = (bufs.cursor.gather(1, e) + rank).clamp(max=cap - 1)
        # a dropped tuple writes back what its spare slot, the one after PE
        # e's new cursor, already holds.  When the chunk fills PE e to its
        # capacity, that slot is the last one, which PE e's last kept tuple
        # of the chunk writes: the dropped tuple then writes that tuple's
        # value and tag, so the duplicate writes carry the same bytes and
        # their order no longer matters
        end = cursor.gather(1, e)
        spare = end.clamp(max=cap - 1).long()
        last = (onehot * torch.arange(1, t + 1, dtype=torch.int32,
                                      device=eff.device)).amax(dim=2) - 1
        writer = last.gather(1, e)
        taken = ~kept & (end >= cap) & (writer >= 0)
        w = writer.clamp(min=0).long()
        value = value.to(torch.int32)
        idx = idx.to(torch.int32)
        slot = torch.where(kept, slot, spare).long()
        value = torch.where(kept[..., None], value,
                            torch.where(taken[..., None], value[lane, w],
                                        bufs.out[lane, e, spare]))
        part = torch.where(kept, idx,
                           torch.where(taken, idx[lane, w], bufs.dst_part[lane, e, spare]))
        bufs.out.index_put_((lane, e, slot), value)
        bufs.dst_part.index_put_((lane, e, slot), part)
        return DPBuffers(out=bufs.out, cursor=cursor, dst_part=bufs.dst_part)

    def merge(bufs: DPBuffers, plan: RoutePlan) -> DPBuffers:
        """Non-decomposable merge: the regions stay apart, with their
        cursors and per-slot partition ids (not a copy: ``run_chunks``
        clones a state before it steps, so they stay as they are)."""
        return bufs

    return DittoSpec(name="dp", pre=pre, init_buffer=init_buffer,
                     combine="add", pe_update=pe_update, merge=merge,
                     tuple_bytes=8, ii_pre=1, ii_pe=2)


def partitions_from_buffers(bufs: DPBuffers, num_parts: int) -> list[np.ndarray]:
    """Host-side region gather: partition p is the concatenation over PEs
    of the slots tagged p, in PE order, then slot order.  One stable sort by
    partition over the written slots, taken in that order.  The fields may
    be tensors or numpy arrays (a session engine's answer)."""
    out, dst_part = torch.as_tensor(bufs.out), torch.as_tensor(bufs.dst_part)
    cursor = torch.as_tensor(bufs.cursor).tolist()
    rows = torch.cat([out[pe, :n] for pe, n in enumerate(cursor)]).cpu().numpy()
    tags = torch.cat([dst_part[pe, :n] for pe, n in enumerate(cursor)]).cpu().numpy()
    return _split_by(rows, tags, num_parts)


def _split_by(rows: np.ndarray, tags: np.ndarray, num_parts: int) -> list[np.ndarray]:
    """rows grouped by tag in [0, num_parts), each group in its rows' order;
    other tags are dropped."""
    keep = (tags >= 0) & (tags < num_parts)
    rows, tags = rows[keep], tags[keep]
    order = np.argsort(tags, kind="stable")
    bounds = np.cumsum(np.bincount(tags, minlength=num_parts))[:-1]
    return np.split(rows[order], bounds)


def oracle(tuples: np.ndarray, radix_bits: int) -> list[np.ndarray]:
    """Sequential partitioner: the tuples of each partition in stream order."""
    return _split_by(tuples, radix_np(tuples[:, 0], radix_bits), 1 << radix_bits)


def multiset_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Partition contents are order-free across PEs; compare [n, 2] int32
    tuples as multisets, each row packed into one int64 key (a sort of
    int64 keys is ~40x faster than one of structured rows)."""
    if a.shape != b.shape:
        return False
    return bool(np.array_equal(np.sort(_row_keys(a)), np.sort(_row_keys(b))))


def _row_keys(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.int64)
    return (a[:, 0] << 32) | (a[:, 1] & 0xFFFFFFFF)
