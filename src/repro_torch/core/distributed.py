"""The skew-oblivious data-routing architecture across devices.

The PyTorch counterpart of ``repro/core/distributed.py``.  ``core/executor``
realizes the paper within one device (PEs = buffer partitions); this module
is the cluster-scale version, where one PE is one shard of a mesh axis and
the combiner/decoder/filter network is an all-to-all exchange:

  PrePE        each shard computes <dst, idx, value> for its slice of the
               chunk (producers are sharded too)
  mapper       per-producer round-robin redirect (each producer has its
               own rank; the plan's table and counter are shared)
  routing      a capacity-bounded all-to-all: producer p packs a
               [P, capacity, 2] send buffer by destination shard; one
               exchange delivers every kept tuple to its effective PE
  PriPE/SecPE  each shard folds its received tuples into its private
               buffer through ``dispatch.pe_buffer_update`` (the
               ``route_accumulate`` kernel on the card, one launch a shard)
  profiler     per-chunk receive loads and the global designated-load
               histogram (``psum``) go back to the host, which plans the
               SecPEs between chunks (``scheduler.schedule_secpes``)
  merger       SecPE shadow buffers fold into their PriPEs at stream end

The JAX package runs these as ``shard_map`` programs over a
``jax.sharding.Mesh`` in one process.  Here the mesh is a tuple of
``torch.device`` s under one axis name (``Mesh``; a device may repeat, so P
logical shards can share one card), every shard's state is a tensor on its
own device, and the two collectives are plain functions over per-shard
tensor lists: ``all_to_all`` moves block [s][d] to shard d, ``psum`` sums
in shard order.  On one card P shards measure the code path and the cost
of the exchange, not multi-card scaling.

``make_lane_sharded_executor`` is the serving-layer lift (DESIGN.md §9):
the slot lanes of ``serve.SessionEngine`` -- each a whole executor carry --
are split over the mesh, ``lanes_per_device`` a shard, so one engine
serves P x lanes_per_device tenants; the §IV-B merge of a re-granted lane
moves the lane's merged buffers to the shard of the lane it folds into.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import executor as core_executor
from repro_torch.core import mapper, profiler, scheduler
from repro_torch.core.executor import ExecState, ResumableExecutor, _tree_map
from repro_torch.core.types import DittoSpec, RoutePlan, resolve_device
from repro_torch.kernels import dispatch


# ------------------------------------------------------------------ the mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """One named axis over a tuple of devices; shard p lives on
    ``devices[p]``.  Devices may repeat (P logical shards on one card).
    ``shape`` is ``{axis: P}``, as a JAX mesh's ``dict(mesh.shape)``."""

    devices: tuple
    axis: str

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def _normalize(device) -> torch.device:
    """A resolved device with its index spelled out (``cuda`` -> the
    current card), so shards compare equal to their tensors' devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_shards: int, axis: str, *, device="cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` of ``num_shards`` shards along ``axis``: all on ``device``
    (``"cuda"``, the default, raises without a CUDA device), or on the
    explicit ``devices`` (one a shard, repeats allowed)."""
    if devices is None:
        if num_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {num_shards}")
        devices = [device] * num_shards
    elif len(devices) != num_shards:
        raise ValueError(f"{len(devices)} devices for {num_shards} shards")
    return Mesh(devices=tuple(_normalize(d) for d in devices), axis=axis)


def all_to_all(send: Sequence[torch.Tensor], devices: Sequence) -> list:
    """The exchange of ``jax.lax.all_to_all(x, axis, 0, 0)``: shard s sends
    block ``send[s][d]`` (``send[s]`` has a leading [P] axis) to shard d,
    which receives them stacked in source order: ``recv[d][s] = send[s][d]``
    on ``devices[d]``."""
    return [torch.stack([blocks[d].to(dev) for blocks in send])
            for d, dev in enumerate(devices)]


def psum(xs: Sequence[torch.Tensor], devices) -> Union[torch.Tensor, list]:
    """The sum of the per-shard tensors ``xs`` in shard order: one copy on
    every device of ``devices`` (a sequence), or a single tensor on
    ``devices`` (one device)."""
    if isinstance(devices, (str, torch.device)):
        total = xs[0].to(devices)
        for x in xs[1:]:
            total = total + x.to(devices)
        return total
    total = psum(xs, devices[0])
    return [total.to(dev) for dev in devices]


def _shard_size(mesh: Mesh, axis: str) -> int:
    shape = dict(mesh.shape)
    if axis not in shape:
        raise KeyError(f"mesh has no '{axis}' axis; mesh axes: {tuple(shape)}")
    return shape[axis]


# --------------------------------------------- the PE-sharded routed executor

def make_distributed_executor(spec: DittoSpec, mesh: Mesh, num_pri: int,
                              num_sec: int, *, capacity: int, axis: str = "pe"):
    """The chunk step with one PE a shard.

    The mesh ``axis`` size P is the physical shard count; num_pri +
    num_sec <= P (inactive shards receive nothing).  Returns
    ``chunk_fn(tuples, buffers, table, counter) -> (buffers, load, dropped,
    workload)``: ``tuples`` [P * T_loc, 2] (shard p takes rows
    [p * T_loc, (p + 1) * T_loc)), ``buffers`` a list of P [1, *local]
    tensors, one on each shard's device, folded in place and returned;
    ``table``/``counter`` the plan's mapper state, shared by every
    producer.  ``load`` [P] counts the tuples each shard received,
    ``dropped`` [P] those each producer dropped past ``capacity`` (the
    per-(producer, destination) budget), ``workload`` [num_pri] is the
    global designated-load histogram; the three on the first shard's
    device.  Each call launches the PE update once a shard."""
    num_pe = _shard_size(mesh, axis)
    if num_pri + num_sec > num_pe:
        raise ValueError(f"num_pri + num_sec = {num_pri + num_sec} PEs need as many "
                         f"shards; the mesh's '{axis}' axis has {num_pe}")
    devices = mesh.devices
    unassigned = {dev: torch.full((num_sec,), -1, dtype=torch.int32, device=dev)
                  for dev in devices}
    neutral = 0 if spec.combine == "add" else torch.iinfo(torch.int32).min

    def produce(tuples_loc, plan, dev):
        """One producer: PrePE, mapper and the packed [P, capacity, 2] send
        buffer (-1 padding, stable order, drops counted)."""
        dst, idx, value = spec.pre(tuples_loc, num_pri)
        rank, _ = mapper.occurrence_rank(
            dst, num_pri, torch.zeros((num_pri,), dtype=torch.int32, device=dev))
        eff = mapper.redirect(plan, dst, rank).long()
        oh = torch.nn.functional.one_hot(eff, num_pe).to(torch.int32)
        pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) - oh).gather(1, eff[:, None])[:, 0]
        keep = pos < capacity
        cell = torch.where(keep, eff * capacity + pos, num_pe * capacity)
        payload = torch.stack([idx.to(torch.int32), value.to(torch.int32)], dim=1)
        send = torch.full((num_pe * capacity + 1, 2), -1, dtype=torch.int32, device=dev)
        send.index_put_((cell,), payload)     # dropped tuples land in the cut last row
        return (send[:-1].view(num_pe, capacity, 2), (~keep).sum(dtype=torch.int32),
                profiler.workload_hist(dst, num_pri))

    def chunk_fn(tuples, buffers, table, counter):
        tuples = torch.as_tensor(tuples)
        if tuples.shape[0] % num_pe:
            raise ValueError(f"a chunk of {tuples.shape[0]} tuples does not split "
                             f"over {num_pe} shards")
        t_loc = tuples.shape[0] // num_pe
        sends, drops, hists = [], [], []
        for p, dev in enumerate(devices):
            plan = RoutePlan(assignment=unassigned[dev], table=table.to(dev),
                             counter=counter.to(dev))
            send, dropped, hist = produce(tuples[p * t_loc:(p + 1) * t_loc].to(dev),
                                          plan, dev)
            sends.append(send)
            drops.append(dropped)
            hists.append(hist)
        recv = all_to_all(sends, devices)                 # [P_src, cap, 2] a shard
        loads = []
        for buf, r in zip(buffers, recv):
            r = r.view(-1, 2)
            valid = r[:, 0] >= 0
            # one PE of the shard: eff 0; the kernel drops the -1 padding
            dispatch.pe_buffer_update(
                buf, torch.zeros_like(r[:, 0]), r[:, 0].contiguous(),
                torch.where(valid, r[:, 1], neutral).contiguous(), spec.combine)
            loads.append(valid.sum(dtype=torch.int32))
        first = devices[0]
        return (buffers, torch.stack([x.to(first) for x in loads]),
                torch.stack([x.to(first) for x in drops]), psum(hists, first))

    return chunk_fn


def run_stream(spec: DittoSpec, mesh: Mesh, tuples, num_pri: int, num_sec: int,
               *, capacity: int, axis: str = "pe", profile_chunks: int = 1,
               on_chunk=None):
    """The host-driven streaming loop (the paper's CPU side): run chunks,
    profile, plan the SecPEs after ``profile_chunks`` chunks, merge at the
    end.

    tuples: [num_chunks, P * T_loc, 2].  Returns (merged [num_pri, *local]
    on the first shard's device, stats) with the JAX package's stats keys
    (``max_load``, ``max_load_postplan``, ``dropped``, ``dropped_postplan``,
    ``assignment``) and the per-chunk ``loads`` and ``drops``.
    ``on_chunk(c, buffers, load, dropped, workload)``, when given, sees each
    chunk's outputs (the buffers are live: copy what you keep)."""
    chunk_fn = make_distributed_executor(spec, mesh, num_pri, num_sec,
                                         capacity=capacity, axis=axis)
    first = mesh.devices[0]
    buffers = [spec.init_buffer(1, dev) for dev in mesh.devices]
    plan = mapper.init_plan(num_pri, num_sec, first)
    hist = torch.zeros((num_pri,), dtype=torch.int32, device=first)
    assignment = torch.full((num_sec,), -1, dtype=torch.int32, device=first)
    loads, drops = [], []
    for c in range(len(tuples)):
        buffers, load, dropped, workload = chunk_fn(tuples[c], buffers, plan.table,
                                                    plan.counter)
        if on_chunk is not None:
            on_chunk(c, buffers, load, dropped, workload)
        loads.append(int(load.max()))
        drops.append(int(dropped.sum()))
        hist = hist + workload
        if c + 1 == profile_chunks and num_sec:
            # the paper's re-enqueue: the plan from the profiling window
            assignment = scheduler.schedule_secpes(hist, num_sec)
            plan = mapper.apply_schedule(mapper.init_plan(num_pri, num_sec, first),
                                         assignment)
    # the merger: SecPE shadow buffers fold into their PriPEs
    merged = torch.cat([b.to(first) for b in buffers[:num_pri]])
    for j, tgt in enumerate(assignment.tolist()):
        if tgt >= 0:
            shadow = buffers[num_pri + j][0].to(first)
            if spec.combine == "add":
                merged[tgt] += shadow
            else:
                torch.maximum(merged[tgt], shadow, out=merged[tgt])
    pc = profile_chunks
    stats = {"max_load": max(loads),
             "max_load_postplan": max(loads[pc:]) if loads[pc:] else None,
             "dropped": sum(drops),
             "dropped_postplan": sum(drops[pc:]),
             "assignment": assignment,
             "loads": loads, "drops": drops}
    return merged, stats


# ------------------------------------------------- the lane-sharded executor

def _to(tree, device):
    return _tree_map(lambda x: x.to(device), tree)


def _cat(trees, device):
    """Lanes-stacked pytrees concatenated on their lanes axis, on
    ``device``."""
    if len(trees) == 1:
        return _to(trees[0], device)
    return _tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *trees)


@dataclasses.dataclass(frozen=True)
class ShardedLaneExecutor:
    """A lanes-stacked ``ResumableExecutor`` split over a mesh axis.

    Global lane g lives on shard ``lane_sharding[g] = g // lanes_per_device``
    at local row ``g % lanes_per_device``.  A sharded state is a list of P
    lanes-stacked ``ExecState`` s, shard p's on ``mesh.devices[p]``.  No
    operation changes its input: each returns a new list (shards it did not
    touch are shared).

      run_lanes(states, chunks, mask)  every shard advances its lanes by
                                       ``res.scan_lanes`` (one PE launch a
                                       shard a batched chunk; no exchange)
      merge_lane(states, i)            merged snapshot of lane i, on its
                                       shard's device
      reset_lanes(states, idx)         lanes ``idx`` fresh, on their shards
      fold_lane(states, src, dst)      §IV-B merge-before-reassign across
                                       shards: src merged on its owner,
                                       moved to dst's shard, folded (add |
                                       max) into dst's PriPE rows; src reset
      take_lanes / put_lanes           gather lanes by global id onto one
                                       device, and scatter them back
      shard_states / gather_states     a whole lanes-stacked state to the
                                       shards and back (checkpoints)

    ``num_lanes`` must split evenly over the axis.  A mesh of one shard is
    the unsharded lane path: the same ``scan_lanes`` over the same state.
    """

    res: ResumableExecutor
    mesh: Mesh
    num_lanes: int
    axis: str
    lanes_per_device: int
    lane_sharding: tuple
    fresh: tuple = dataclasses.field(repr=False)     # one fresh lane a shard

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    def _locate(self, lane: int) -> tuple:
        lane = int(lane)
        if not 0 <= lane < self.num_lanes:
            raise IndexError(f"lane {lane} outside [0, {self.num_lanes})")
        return self.lane_sharding[lane], lane % self.lanes_per_device

    def _group(self, idx) -> dict:
        """{shard: ([positions in idx], [local rows])} in first-seen order."""
        out: dict = {}
        for pos, lane in enumerate(idx):
            p, row = self._locate(lane)
            out.setdefault(p, ([], []))
            out[p][0].append(pos)
            out[p][1].append(row)
        return out

    def init_states(self) -> list:
        return [core_executor.stack_states(f, self.lanes_per_device) for f in self.fresh]

    def shard_states(self, states: ExecState) -> list:
        """A whole lanes-stacked state (all ``num_lanes`` lanes, on any
        device) split over the shards."""
        n = self.lanes_per_device
        return [_tree_map(lambda x: x[p * n:(p + 1) * n].to(dev), states)
                for p, dev in enumerate(self.devices)]

    def gather_states(self, states: list, device=None) -> ExecState:
        """Every lane in one lanes-stacked state on ``device`` (default:
        the first shard's)."""
        return _cat(states, device or self.devices[0])

    def run_lanes(self, states: list, chunks, mask=None):
        """chunks [num_lanes, K, chunk_size, ...] and mask bool[num_lanes,
        K, chunk_size] (host or device): shard p scans rows of its lanes.
        Returns (states, ExecStats [num_lanes, K, ...] on the first
        shard's device)."""
        n = self.lanes_per_device
        new, stats = [], []
        for p, st in enumerate(states):
            rows = slice(p * n, (p + 1) * n)
            s, k = self.res.scan_lanes(st, chunks[rows],
                                       None if mask is None else mask[rows])
            new.append(s)
            stats.append(k)
        return new, _cat(stats, self.devices[0])

    def merge_lane(self, states: list, i: int):
        p, row = self._locate(i)
        return self.res.merge_state(core_executor.take_lanes(states[p], row))

    def reset_lanes(self, states: list, idx) -> list:
        """Lanes ``idx`` fresh, one scatter a shard they live on; duplicate
        ids are legal (the same fresh value lands twice)."""
        new = list(states)
        for p, (_, rows) in self._group(idx).items():
            new[p] = core_executor.put_lanes(
                new[p], rows, core_executor.stack_states(self.fresh[p], len(rows)))
        return new

    def reset_lane(self, states: list, i: int) -> list:
        return self.reset_lanes(states, [i])

    def fold_lane(self, states: list, src: int, dst: int) -> list:
        """Fold lane ``src`` into lane ``dst``'s PriPE rows (add | max of
        src's merged buffers), then reset ``src``.  Decomposable specs
        only."""
        if self.res.spec.merge is not None:
            raise ValueError(f"{self.res.spec.name}: non-decomposable buffers cannot "
                             "be folded across lanes")
        pd, row = self._locate(dst)
        contrib = self.merge_lane(states, src).to(self.devices[pd])
        bufs = states[pd].buffers.clone()
        rows = bufs[row, :self.res.num_pri]
        if self.res.spec.combine == "add":
            rows.add_(contrib)
        else:
            torch.maximum(rows, contrib, out=rows)
        new = list(states)
        new[pd] = dataclasses.replace(states[pd], buffers=bufs)
        return self.reset_lanes(new, [src])

    def take_lanes(self, states: list, idx, device=None):
        """The lanes ``idx`` (global ids) as one lanes-stacked state in
        ``idx`` order on ``device`` (default: the shard of ``idx[0]``); an
        int gives that lane's state.  Lanes of one shard are one gather
        there."""
        if isinstance(idx, (int, np.integer)):
            p, row = self._locate(idx)
            return _to(core_executor.take_lanes(states[p], row), device or self.devices[p])
        idx = [int(i) for i in idx]
        groups = self._group(idx)
        target = device or self.devices[self.lane_sharding[idx[0]]]
        parts = [core_executor.take_lanes(states[p], rows) for p, (_, rows) in groups.items()]
        if len(parts) == 1:
            return _to(parts[0], target)
        order = [pos for poss, _ in groups.values() for pos in poss]
        inverse = np.argsort(order).tolist()
        return core_executor.take_lanes(_cat(parts, target), inverse)

    def put_lanes(self, states: list, idx, sub: ExecState) -> list:
        """``states`` with lanes ``idx`` replaced by ``sub`` (lanes-stacked
        in ``idx`` order, on any device): the inverse of ``take_lanes``."""
        idx = [int(i) for i in idx]
        new = list(states)
        for p, (poss, rows) in self._group(idx).items():
            part = core_executor.take_lanes(sub, poss)
            new[p] = core_executor.put_lanes(new[p], rows, _to(part, self.devices[p]))
        return new


def make_lane_sharded_executor(res: ResumableExecutor, mesh: Mesh, num_lanes: int, *,
                               axis: str = "lanes") -> ShardedLaneExecutor:
    """``num_lanes`` slot lanes of ``res`` split over ``mesh``'s ``axis``,
    ``num_lanes / P`` a shard (see ``ShardedLaneExecutor``)."""
    num_dev = _shard_size(mesh, axis)
    if num_lanes % num_dev:
        raise ValueError(
            f"num_lanes={num_lanes} must be divisible by the mesh's "
            f"'{axis}' axis size {num_dev} (the lanes split evenly over the "
            "shards); pad primary/secondary slots up")
    per = num_lanes // num_dev
    fresh = {}
    for dev in mesh.devices:
        if dev not in fresh:
            fresh[dev] = dataclasses.replace(res, device=dev).init_state()
    return ShardedLaneExecutor(
        res=res, mesh=mesh, num_lanes=num_lanes, axis=axis, lanes_per_device=per,
        lane_sharding=tuple(g // per for g in range(num_lanes)),
        fresh=tuple(fresh[dev] for dev in mesh.devices))
