"""PR -- PageRank in fixed-point arithmetic (paper Table I, §VI-C2).

Scatter-gather PageRank: each iteration routes one tuple per edge,
<dst_vertex, contrib> with contrib = rank[src] / out_deg[src], and the PEs
accumulate the contributions into the partitioned vertex state (vertex v
lives in PriPE v % M at local index v // M).  Undirected and high-degree
graphs give severe destination skew (Fig. 8); the SecPEs flatten it.  The
PE update is the default one, ``dispatch.pe_buffer_update`` (the
``route_accumulate`` kernel on the card).

Fixed point: Q16.16 in int32, with ranks scaled by V (a uniform rank is
ONE) so that small ranks keep their precision.  The total mass is V * ONE,
so int32 sums are safe for V <= 2^14 (asserted).  The oracle takes the same
fixed-point path, so the comparisons are bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import DittoSpec

FRAC_BITS = 16
ONE = 1 << FRAC_BITS
MAX_VERTICES = 1 << 14  # V * ONE must stay inside int32
DAMPING_FIXED = int(0.85 * ONE)


def make_spec(num_vertices: int, num_pri: int) -> DittoSpec:
    """Spec of the scatter phase.  Tuples are <dst_vertex, contrib_fixed>
    (from ``edge_contributions``); the PrePE splits the vertex id into
    (PE, local index)."""
    assert num_vertices <= MAX_VERTICES, "Q16.16/int32 budget (see module doc)"
    verts_per_pe = -(-num_vertices // num_pri)

    def pre(chunk, num_pri_):
        v = chunk[..., 0].to(torch.int32)
        # the last column: a bare-key sample (Ditto.select) has one, and
        # JAX's clamped index reads that one column too; contiguous, as the
        # PE update's kernel takes it
        contrib = chunk[..., -1].to(torch.int32).contiguous()
        return (v % num_pri_).to(torch.int32), (v // num_pri_).to(torch.int32), contrib

    def init_buffer(num_pe, device):
        return torch.zeros((num_pe, verts_per_pe), dtype=torch.int32, device=device)

    return DittoSpec(name="pagerank", pre=pre, init_buffer=init_buffer,
                     combine="add", tuple_bytes=8, ii_pre=1, ii_pe=2)


def edge_contributions(edges: torch.Tensor, rank_fixed: torch.Tensor,
                       out_deg: torch.Tensor) -> torch.Tensor:
    """PrePE gather: the [E, 2] int32 <dst, rank[src] // deg[src]> tuples of
    one iteration, on the device of ``edges``.  Integer floor division keeps
    Q16.16 (the rank is already scaled)."""
    src, dst = edges[:, 0].long(), edges[:, 1]
    deg = out_deg[src].to(torch.int32).clamp(min=1)
    contrib = torch.div(rank_fixed[src].to(torch.int32), deg, rounding_mode="floor")
    return torch.stack([dst.to(torch.int32), contrib.to(torch.int32)], dim=1)


def init_rank(num_vertices: int) -> np.ndarray:
    """Uniform start: every vertex holds ONE (the scaled-by-V form)."""
    return np.full(num_vertices, ONE, np.int32)


def apply_damping(sums_fixed: np.ndarray, num_vertices: int,
                  damping_fixed: int = DAMPING_FIXED) -> np.ndarray:
    """Gather phase on the merged buffers: r' = (1-d)*ONE + d*sum (scaled by
    V).  [M, verts_per_pe] int32 partitioned sums -> flat [V] int32 ranks."""
    m, _ = sums_fixed.shape
    v = np.arange(num_vertices)
    s = sums_fixed[v % m, v // m].astype(np.int64)
    r = (ONE - damping_fixed) + ((damping_fixed * s) >> FRAC_BITS)
    return r.astype(np.int32)


def oracle_scatter(edges: np.ndarray, rank_fixed: np.ndarray,
                   out_deg: np.ndarray, num_vertices: int,
                   num_pri: int) -> np.ndarray:
    """Bit-exact oracle of one routed scatter phase -> [M, vpp] int32 sums."""
    src, dst = edges[:, 0], edges[:, 1]
    contrib = (rank_fixed[src].astype(np.int64)
               // np.maximum(out_deg[src], 1)).astype(np.int32)
    out = np.zeros((num_pri, -(-num_vertices // num_pri)), np.int32)
    np.add.at(out, (dst % num_pri, dst // num_pri), contrib)
    return out


def pagerank_reference(edges: np.ndarray, num_vertices: int,
                       iters: int = 10) -> np.ndarray:
    """Float64 PageRank (unscaled, sums to 1), the sanity check of the
    fixed-point pipeline: |fixed / (V * ONE) - float| stays small."""
    deg = np.zeros(num_vertices)
    np.add.at(deg, edges[:, 0], 1)
    r = np.full(num_vertices, 1.0 / num_vertices)
    for _ in range(iters):
        s = np.zeros(num_vertices)
        np.add.at(s, edges[:, 1], r[edges[:, 0]] / np.maximum(deg[edges[:, 0]], 1))
        r = 0.15 / num_vertices + 0.85 * s
    return r
