"""Sharding policies: logical axis conventions -> DTensor placements on a
``DeviceMesh``, the PyTorch counterpart of ``repro/sharding/policies.py``.

Conventions (see models/layers.py):
  'model'          tensor parallelism: heads / experts / vocab / d_ff
  'data'           FSDP parameter+optimizer sharding AND batch data axis
  ('pod','data')   batch dimension of activations/caches (explicit in specs)

A spec is a ``P``: one entry a tensor dimension, each None (unsharded), a
mesh axis name or a tuple of names.  ``promote_fsdp`` widens parameter FSDP
sharding onto the pod axis when the mesh has one: a bare 'data' in a
PARAMETER spec becomes ('data','pod'), so on the 2x32x8 production mesh
parameters and optimizer state shard 64-way instead of 32-way (ZeRO-3
across pods).  Batch/cache specs already name ('pod','data') explicitly
and are untouched.

``named_sharding_tree`` turns a spec tree into ``MeshSharding``s, whose
``placements`` are DTensor's: an entry naming axes (a, b) on tensor dim i
becomes ``Shard(i)`` on mesh dims a and b, every other mesh dim gets
``Replicate()``.  JAX splits one dim over the axes of an entry in the
entry's order (('data','pod'): data major); DTensor splits it over its mesh
dims in mesh order (pod before data on the production mesh).  The local
shard shapes agree; which rank holds which block differs.

A mesh here is a ``DeviceMesh`` with named dims, or a plain mapping
{axis name: size} where only shapes matter (``mesh_axes``).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

from repro_torch.tree import tree_map


class P:
    """A per-dimension sharding spec, as ``jax.sharding.PartitionSpec``
    normalizes one: a one-name tuple is that name, an empty tuple None."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_normalize(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}" if len(self) != 1 else f"P({self._entries[0]!r})"


def _normalize(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def promote_fsdp(spec_tree: Any, mesh) -> Any:
    """Replace bare 'data' entries with ('data','pod') when the mesh has a
    pod axis.  Entries that are tuples (already explicit) pass through."""
    if "pod" not in mesh_axes(mesh):
        return spec_tree
    return tree_map(lambda p: P(*(("data", "pod") if ax == "data" else ax for ax in p)),
                    spec_tree)


def _clean_entry(ax, axes: dict) -> tuple:
    """One spec entry as a tuple of the mesh's axes."""
    if ax is None:
        return ()
    names = ax if isinstance(ax, tuple) else (ax,)
    return tuple(a for a in names if a in axes)


def _fit_spec(p: P, shape, mesh) -> P:
    """Drop mesh axes a dimension cannot divide: axes go from the END of an
    entry until the product divides the dim -- e.g. kv-heads=8 over a
    16-way 'model' axis becomes unsharded; batch=1 over ('pod','data')
    becomes unsharded; ('data','pod') = 64 stays when d_model % 64 == 0."""
    axes = mesh_axes(mesh)
    clean = []
    for i, ax in enumerate(p):
        names = list(_clean_entry(ax, axes))
        dim = shape[i] if (shape is not None and i < len(shape)) else None
        if dim is not None:
            while names and dim % math.prod(axes[a] for a in names):
                names.pop()
        clean.append(tuple(names) if names else None)
    return P(*clean)


class MeshSharding:
    """A fitted spec on a mesh: what ``NamedSharding`` is to JAX (a leaf of
    the port's trees, not a container)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"MeshSharding({mesh_axes(self.mesh)}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: Shard(i) where entry i names
        the dim, else Replicate()."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_axes(self.mesh):
            dims = [i for i, ax in enumerate(self.spec)
                    if name in _clean_entry(ax, {name: 1})]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local_shape(self, shape) -> tuple:
        """The shard shape of a tensor of ``shape`` on one rank (the fitted
        entries divide their dims)."""
        axes = mesh_axes(self.mesh)
        out = list(shape)
        for i, ax in enumerate(self.spec):
            n = math.prod(axes[a] for a in _clean_entry(ax, axes))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {ax}")
            out[i] //= n
        return tuple(out)


def named_sharding_tree(spec_tree: Any, mesh, params: bool = False,
                        shapes: Any = None) -> Any:
    """Spec tree -> MeshSharding tree.

    params=True applies the FSDP pod promotion; ``shapes`` (a matching tree
    of tensors, meta ones included) enables the divisibility fixup."""
    if params:
        spec_tree = promote_fsdp(spec_tree, mesh)
    if shapes is None:
        return tree_map(lambda p: MeshSharding(mesh, _fit_spec(p, None, mesh)), spec_tree)

    # one spec leaf pairs with the matching tensor (or subtree, if one spec
    # covers several)
    def fix(p, sub):
        return tree_map(lambda t: MeshSharding(mesh, _fit_spec(p, t.shape, mesh)), sub)

    return tree_map(fix, spec_tree, shapes)


def to_shardings(spec_tree: Any, mesh, params: bool = False, shapes: Any = None) -> Any:
    return named_sharding_tree(spec_tree, mesh, params=params, shapes=shapes)


def tp_only(spec_tree: Any) -> Any:
    """Serving-time parameter policy: keep tensor parallelism ('model'),
    replicate across the data/pod axes.  FSDP-sharded decode params force
    per-layer all-gathers on every decoded token; when the TP-sharded copy
    fits HBM, replicating over 'data' removes that collective."""
    def fix(p: P) -> P:
        out = []
        for ax in p:
            names = ax if isinstance(ax, tuple) else (ax,)
            kept = tuple(a for a in names if a is not None and a not in ("data", "pod"))
            out.append(kept if kept else None)
        return P(*out)

    return tree_map(fix, spec_tree)


def replicated(mesh) -> MeshSharding:
    return MeshSharding(mesh, P())
