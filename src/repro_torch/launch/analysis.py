"""Dry-run analysis: memory, collectives and the roofline terms, the
counterpart of ``repro/launch/analysis.py``.

The port has no compiled artifact to read: the dry run builds a cell's
state on ``meta`` and fits its sharding specs (launch/dryrun.py), so

- memory is summed from the local shard shapes (``extract_memory``);
- collectives are records that the dry run derives from the fitted spec
  trees, each (kind, result bytes a device, group size, trip count), and
  ``collective_stats`` applies the standard ring-algorithm byte counts
  to them, as ``parse_collectives`` does to the HLO's collectives.

Three roofline terms per (arch x shape x mesh) cell, per device:

    compute    = FLOPs / (chips x peak_FLOP/s)
    memory     = bytes / (chips x HBM_bw)
    collective = network bytes a device / link_bw
                 + NVLink bytes a device / nvlink_bw

A record whose mesh axes all lie inside a node (``Hardware.nvlink_axes``)
moves its bytes over NVLink; the rest cross the network.  The two links'
times add (no overlap), as JAX's one term charges every byte to one link.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, NamedTuple

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "ragged-all-to-all")


class Collective(NamedTuple):
    """One collective of a step: its kind, the bytes of its result on one
    device, the size of its group and how many times a step runs it."""
    kind: str
    result_bytes: float
    group: int
    trip: int = 1
    axes: tuple = ()        # the mesh axes its group spans
    what: str = ""          # the leaf or tensor it moves


def _moved_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Ring-algorithm bytes crossing a chip boundary per chip."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind == "all-gather":
        return (g - 1) / g * result_bytes           # result is full buffer
    if kind == "reduce-scatter":
        return (g - 1) * result_bytes               # result is 1/g of input
    if kind in ("all-to-all", "ragged-all-to-all"):
        return (g - 1) / g * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


def collective_stats(records: Iterable[Collective], hw=None) -> Dict[str, Any]:
    """Collective records -> per-kind stats and the bytes a device moves in
    a step: {"per_kind": {kind: {count, bytes_moved, result_bytes,
    in_scan}}, "bytes_moved_total"}, ``parse_collectives``'s dict.  A
    record with trip > 1 (a per-layer leaf) counts as one op ``in_scan``,
    its bytes times its trips.  Given ``hw``, also "bytes_moved_nvlink",
    the part of the total whose records stay on ``hw``'s NVLink axes."""
    stats: Dict[str, Dict[str, float]] = {}
    total = nvlink = 0.0
    for r in records:
        if r.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"collective kind {r.kind!r}")
        mv = _moved_bytes(r.kind, r.result_bytes, r.group) * r.trip
        k = stats.setdefault(r.kind, {"count": 0, "bytes_moved": 0.0,
                                      "result_bytes": 0.0, "in_scan": 0})
        k["count"] += 1
        k["in_scan"] += int(r.trip > 1)
        k["bytes_moved"] += mv
        k["result_bytes"] += r.result_bytes
        total += mv
        if hw is not None and hw.on_nvlink(r.axes):
            nvlink += mv
    out = {"per_kind": stats, "bytes_moved_total": total}
    if hw is not None:
        out["bytes_moved_nvlink"] = nvlink
    return out


# ------------------------------------------------------------------ roofline

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, hw,
                   nvlink_coll_bytes: float = 0.0) -> RooflineTerms:
    """Per-device quantities over per-card rates (``launch.mesh.Hardware``).
    ``nvlink_coll_bytes`` is the part of ``per_device_coll_bytes`` that
    stays on NVLink."""
    return RooflineTerms(
        compute_s=per_device_flops / hw.peak_flops,
        memory_s=per_device_bytes / hw.hbm_bw,
        collective_s=((per_device_coll_bytes - nvlink_coll_bytes) / hw.link_bw
                      + nvlink_coll_bytes / hw.nvlink_bw),
    )


# -------------------------------------------------------------------- memory

def shard_bytes(tree: Any, shardings: Any) -> int:
    """Bytes of one device's shards of a tree of (meta) tensors, each leaf
    paired with its ``MeshSharding``."""
    from repro_torch.tree import tree_leaves, tree_map
    sizes = tree_map(lambda t, sh: math.prod(sh.local_shape(t.shape)) * t.element_size(),
                     tree, shardings)
    return sum(tree_leaves(sizes))


def extract_memory(args: Any, in_shardings: Any, outs: Any = None,
                   out_shardings: Any = None, unused_bytes: int = 0,
                   hbm_bytes: float = 0.0) -> Dict[str, float]:
    """Per-device argument and output bytes, summed from the local shard
    shapes.  ``argument_size_in_bytes`` leaves out ``unused_bytes``, the
    arguments the step never reads, as jit drops them from a compiled
    step's (its ``memory_analysis``); ``resident_argument_bytes`` keeps
    them, and ``fits_hbm`` says whether those fit ``hbm_bytes``."""
    resident = shard_bytes(args, in_shardings)
    out = {"argument_size_in_bytes": float(resident - unused_bytes),
           "resident_argument_bytes": float(resident)}
    if outs is not None:
        out["output_size_in_bytes"] = float(shard_bytes(outs, out_shardings))
    if hbm_bytes:
        out["fits_hbm"] = resident <= hbm_bytes
    return out
