"""Data-routing logic (paper §IV-C1): the structural reference and the
multi-device realization.

The FPGA router is a combiner/decoder/filter channel network: the combiner
copies each beat of N tuples to the M+X datapaths; each datapath's decoder
compares the destination ids against its own PE id, which gives an N-bit
mask code, and looks the positions and count of the tuples to keep up in a
preset table; the filter extracts them.

  * ``decode_filter``    -- one datapath (mask code + position table);
  * ``route_dense``      -- every datapath at once, a leading PE axis;
  * ``route_all_to_all`` -- PEs sharded over a mesh axis
                            (``core.distributed.Mesh``): each shard bins
                            its tuples by destination shard and one
                            ``all_to_all`` delivers them.

The executor does not call these: its routed update scatters straight into
the PE buffers.  The tests use them to show that the per-PE streams are
the same.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import all_to_all


def decode_filter(dst_eff: torch.Tensor, pe_id: int,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One datapath's decoder and filter: the int32 positions of the tuples
    this PE must process, in stream order, padded with -1 to ``capacity``
    (positions past it are cut), and their int32 count."""
    mask = dst_eff == pe_id
    kept = torch.nonzero(mask)[:capacity, 0].to(torch.int32)
    positions = torch.full((capacity,), -1, dtype=torch.int32, device=dst_eff.device)
    positions[:kept.numel()] = kept
    return positions, mask.sum(dtype=torch.int32)


def route_dense(dst_eff: torch.Tensor, num_pe: int,
                capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every datapath at once: positions [num_pe, capacity] and counts
    [num_pe], row p being ``decode_filter(dst_eff, p, capacity)``.  A
    stable compaction: the k-th tuple of PE p lands in column k of row p."""
    t = dst_eff.shape[0]
    pes = torch.arange(num_pe, dtype=dst_eff.dtype, device=dst_eff.device)
    mask = dst_eff[None, :] == pes[:, None]                      # [P, T]
    col = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (col < capacity)
    rows = torch.arange(num_pe, device=dst_eff.device)[:, None].expand(num_pe, t)
    src = torch.arange(t, dtype=torch.int32, device=dst_eff.device).expand(num_pe, t)
    positions = torch.full((num_pe, capacity), -1, dtype=torch.int32,
                           device=dst_eff.device)
    positions[rows[keep], col[keep].long()] = src[keep]
    return positions, mask.sum(dim=1, dtype=torch.int32)


def route_all_to_all(tuples: torch.Tensor, dst_eff: torch.Tensor, num_pe: int,
                     capacity: int, mesh, axis: str = "model",
                     fill_value: int = 0) -> tuple[list, list]:
    """Cross-device data routing.  ``tuples`` [P * T_loc, ...] and
    ``dst_eff`` [P * T_loc] split evenly over the mesh's ``axis`` (shard s
    produces rows [s * T_loc, (s + 1) * T_loc)); PE e lives on shard
    ``e // (num_pe // P)``.  Each source shard bins its tuples by
    destination shard in stream order, the first ``capacity`` of each bin
    kept (the FPGA channel depth); the rest, and tuples whose shard lies
    outside [0, P), are dropped.  One ``all_to_all`` delivers the bins.

    Returns (routed, valid), one entry a shard on its device: routed[d]
    [P, capacity, ...] holds in row s the tuples source s sent to shard d,
    ``fill_value`` past them; valid[d] bool[P, capacity] marks them."""
    n_shards = dict(mesh.shape)[axis]
    pe_per_shard = num_pe // n_shards
    t_loc = tuples.shape[0] // n_shards
    if t_loc * n_shards != tuples.shape[0] or dst_eff.shape[0] != tuples.shape[0]:
        raise ValueError(f"{tuples.shape[0]} tuples and {dst_eff.shape[0]} "
                         f"destinations do not split over {n_shards} shards")
    bins, valids = [], []
    for s, dev in enumerate(mesh.devices):
        tup = tuples[s * t_loc:(s + 1) * t_loc].to(dev)
        shard_of = dst_eff[s * t_loc:(s + 1) * t_loc].to(dev).long() // pe_per_shard
        ok = (shard_of >= 0) & (shard_of < n_shards)
        shard_of = torch.where(ok, shard_of, n_shards)           # a spare bin, cut
        onehot = torch.nn.functional.one_hot(shard_of, n_shards + 1).to(torch.int32)
        rank = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) \
            .gather(1, shard_of[:, None])[:, 0]
        keep = ok & (rank < capacity)
        cell = torch.where(keep, shard_of * capacity + rank, n_shards * capacity)
        b = torch.full((n_shards * capacity + 1, *tup.shape[1:]), fill_value,
                       dtype=tup.dtype, device=dev)
        b.index_put_((cell,), tup)
        v = torch.zeros(n_shards * capacity + 1, dtype=torch.bool, device=dev)
        v.index_put_((cell,), keep)
        bins.append(b[:-1].view(n_shards, capacity, *tup.shape[1:]))
        valids.append(v[:-1].view(n_shards, capacity))
    return all_to_all(bins, mesh.devices), all_to_all(valids, mesh.devices)
