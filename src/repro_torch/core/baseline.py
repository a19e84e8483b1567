"""The static-dispatch, replicated-buffer baseline (paper Fig. 1a).

The design Ditto is compared against (the HLS works [3], [12]): tuple i
goes to PE i mod M, with no routing, so EVERY PE holds a full replica of
the buffered state (buffer cost x M), and the replicas are aggregated after
the stream (the paper's "CPU-side intervention").  Static dispatch is immune
to skew (each PE absorbs 1/M of the stream); its cost is memory.  Table
II's routing-vs-replication trade is computed against this executor.

The PE update is the app's own: ``spec.pe_update`` where the spec has one
(HHD's ``cms_update``), else ``dispatch.pe_buffer_update``.  So on the card
the baseline runs the same hand-written kernels as the routed executor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import perfmodel
from repro_torch.core.types import DittoSpec, resolve_device
from repro_torch.kernels import dispatch


def make_replicated_executor(spec: DittoSpec, num_pe: int, chunk_size: int,
                             *, mem_width_tuples: int = 8, device="cuda"):
    """Static dispatch: chunk position i -> PE i % num_pe, each PE folding
    into its own FULL replica.  ``spec`` is the app at one PriPE
    (``make_spec(..., num_pri=1)``), whose ``pre`` gives global indices.

    Returns fn(tuples [C, chunk, ...]) -> (aggregated buffer [1, *local],
    {"chunk_cycles": float32[C], "merge_cycles": float32 scalar}).
    """
    device = resolve_device(device)
    pe = torch.arange(chunk_size, dtype=torch.int32, device=device) % num_pe
    # static dispatch: every PE absorbs ceil(chunk / M) tuples, whatever the skew
    cycles = perfmodel.chunk_cycles(
        chunk_size, torch.tensor(-(-chunk_size // num_pe), device=device),
        mem_width_tuples, spec.ii_pe)

    def pe_update(buffers, idx, value):
        if spec.pe_update is not None:
            return spec.pe_update(buffers, pe, idx, value)
        return dispatch.pe_buffer_update(buffers, pe, idx, value.to(buffers.dtype),
                                         spec.combine)

    def run(tuples):
        tuples = torch.as_tensor(tuples, device=device)
        local = spec.init_buffer(1, device)[0]        # the full state
        buffers = torch.zeros((num_pe, *local.shape), dtype=local.dtype,
                              device=device)
        for chunk in tuples:
            _, idx, value = spec.pre(chunk, 1)        # dst = 0, idx global
            buffers = pe_update(buffers, idx, value)
        # the post-hoc aggregation of M replicas: one pass over M x state
        agg = (buffers.sum(dim=0, dtype=buffers.dtype) if spec.combine == "add"
               else buffers.amax(dim=0))
        merge_cycles = torch.tensor(np.float32(buffers.numel() / mem_width_tuples),
                                    device=device)
        return agg[None], {"chunk_cycles": cycles.repeat(tuples.shape[0]),
                           "merge_cycles": merge_cycles}

    return run


def replica_buffer_bytes(spec: DittoSpec, num_pe: int) -> int:
    """Per-PE buffer bytes of the replicated design (the full state each);
    ``spec`` at one PriPE, as for ``make_replicated_executor``."""
    full = spec.init_buffer(1, torch.device("meta"))[0]
    return full.numel() * full.element_size()


def routed_buffer_bytes(spec: DittoSpec, num_pri: int, num_sec: int) -> int:
    """Per-PE buffer bytes of data routing (1/M of the state each)."""
    buf = spec.init_buffer(num_pri + num_sec, torch.device("meta"))
    return buf[0].numel() * buf.element_size()
