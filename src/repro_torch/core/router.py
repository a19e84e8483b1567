"""Data-routing logic (paper §IV-C1), the structural reference.

The FPGA router is a combiner/decoder/filter channel network: the combiner
copies each beat of N tuples to the M+X datapaths; each datapath's decoder
compares the destination ids against its own PE id, which gives an N-bit
mask code, and looks the positions and count of the tuples to keep up in a
preset table; the filter extracts them.

  * ``decode_filter`` -- one datapath (mask code + position table);
  * ``route_dense``   -- every datapath at once, a leading PE axis.

The executor does not call these: its routed update scatters straight into
the PE buffers.  The tests use them to show that the per-PE streams are
the same.  (The JAX package's multi-device ``route_all_to_all`` is not
ported yet.)
"""
from __future__ import annotations

import torch


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
