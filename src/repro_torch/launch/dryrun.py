"""Multi-node dry run: prove the distribution config is coherent, without
a card -- the counterpart of ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell and each production mesh
(256 ranks, ("data", "model") = (32, 8); 512 ranks, ("pod", "data",
"model") = (2, 32, 8)) a cell's state -- params, optimizer state, batch,
cache -- is built on ``meta``; its spec trees are fitted to the mesh
(``policies._fit_spec``) and every leaf is ``distribute_tensor``'d onto
the mesh, whose local shard must have the fitted shape (a placement the
mesh cannot take fails the cell, as a failed compile does in JAX).  The
process group is ``fake`` (one process stands for every rank), so nothing
is allocated and nothing runs:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --out experiments/dryrun_torch

Each cell records its per-device argument bytes (those its step reads,
as jit counts a compiled step's, and every resident leaf, which must fit
the card's 80e9), the analytic FLOPs and bytes (launch/costmodel.py), the
spec-derived collectives and the roofline terms on ``mesh.H100``, into
one JSON a cell.  Existing JSONs are skipped unless --force.

The port has no partitioner to read a collective schedule from, so the
collectives come from the fitted spec trees by these rules
(``cost_source: "analytic+spec-collectives"``):

(a) each parameter leaf sharded over 'data'/'pod' is all-gathered over
    those axes once for prefill or decode and twice for a training step
    (forward and backward), in its stored dtype, one layer at a time;
(b) in training, that leaf's float32 gradient is reduce-scattered over
    the same axes; a leaf not sharded over them has its float32 gradient
    all-reduced over the batch's axes (plain data parallelism);
(c) each application of a leaf sharded over 'model' on a contracting dim
    (attention and MLA ``wo``, the MLP's ``down``, Mamba's ``out_proj``,
    the embedding lookup over its vocab rows) all-reduces its output
    [tokens a device, out features] in the compute dtype over 'model';
    twice in training (the backward's matching all-reduce of the input's
    gradient, Megatron's f/g pair);
(d) an MoE layer whose expert leaves shard over 'model' on the expert dim
    costs one all-to-all of its dispatched tokens (the packed [groups,
    slots, capacity, d] buffer a device) each way; twice that in training.

The contracting dims come from the model (``Model.params_contracting``,
beside each module's ``*_pspec``); a leaf sharded over 'model' that has
none fails the cell.  Each record names the mesh axes it spans, so the
roofline charges (a), (b) at the network link and (c), (d) at NVLink
(``mesh.Hardware``).

Not counted: the decode attention's partial sums over a sequence-sharded
cache, the loss's reductions over a vocab-sharded logit row, and the
scalars.  Leaves a step does not read (``Model.decode_unread``: whisper's
encoder at decode, its cross-attention K/V projections) move nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ALIASES, get
from repro_torch.configs.base import SHAPES, shape_spec
from repro_torch.launch import analysis as AN
from repro_torch.launch import costmodel as CM
from repro_torch.launch.dryrun_rules import cell_skip_reason
from repro_torch.launch.mesh import H100, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import zoo
from repro_torch.models.transformer import _stack, take
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.sharding import policies as SH
from repro_torch.sharding.policies import P
from repro_torch.train import state as TS
from repro_torch.tree import tree_map

ARCHS = list(ALIASES)          # the dashed ids, as the JAX dry run's --arch
WORLD = 512                    # ranks of the fake process group: both meshes

# bf16 param bytes a device under which decode params replicate over
# 'data' (--opt): the JAX package's budget is 37.5% of its chip's HBM
# (repro/launch/dryrun.py); the same share of the H100's 80e9 is 30e9
TP_ONLY_HBM_BUDGET = 0.375 * H100.hbm_bytes


@contextlib.contextmanager
def fake_process_group(world: int = WORLD):
    """A ``fake`` default process group of ``world`` ranks in this process
    (rank 0), torn down on exit: meshes of any size build on one host."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place_moe_abstract(cfg, params, pspec, contracting):
    """Meta version of the Ditto slot-weight placement for every MoE ffn in
    the stacked blocks tree, and the matching spec and contracting-dim
    surgery (the placement itself is a per-plan serve-side pass,
    moe.place_slot_weights)."""
    moe_keys = [f"{j}.ffn" for j, fk in enumerate(cfg.ffn_pattern) if fk == "moe"]
    if not moe_keys:
        return params, pspec, contracting
    assignment = torch.zeros((cfg.ditto_secondary,), dtype=torch.int32, device=L.META)
    blocks, blocks_pspec = dict(params["blocks"]), dict(pspec["blocks"])
    blocks_contracting = dict(contracting["blocks"])
    unstacked = lambda tr: tree_map(lambda p: P(*p[1:]), tr)
    for k in moe_keys:
        periods = []
        for i in range(cfg.num_periods):
            placed = MOE.place_slot_weights(take(blocks[k], i), assignment,
                                            cfg.num_experts, dtype=cfg.cdtype)
            placed.pop("slot_assignment")    # period-independent, added below
            periods.append(placed)
        blocks[k] = _stack(periods)
        # a leading periods axis, as every other per-period leaf
        blocks[k]["slot_assignment"] = torch.zeros(
            (cfg.num_periods, cfg.ditto_secondary), dtype=torch.int32, device=L.META)
        spec = MOE.slot_weights_pspec(unstacked(blocks_pspec[k]))
        spec.pop("slot_assignment")
        spec = tree_map(lambda p: P(None, *p), spec)
        spec["slot_assignment"] = P(None, None)
        blocks_pspec[k] = spec
        blocks_contracting[k] = MOE.slot_weights_contracting(blocks_contracting[k])
    return (dict(params, blocks=blocks), dict(pspec, blocks=blocks_pspec),
            dict(contracting, blocks=blocks_contracting))


def _bf16_params(model):
    """Serving stores params in the compute dtype (bf16 checkpoints)."""
    cd = model.cfg.cdtype
    return tree_map(lambda t: t.to(cd) if t.is_floating_point() else t,
                    model.init_params(L.ShapeOnly()))


@dataclasses.dataclass
class Cell:
    """One cell's meta arguments, their fitted shardings, its outputs, its
    params' contracting dims and unread subtrees, and how its params are
    served."""
    kind: str
    args: tuple
    in_shardings: tuple
    outs: tuple
    out_shardings: tuple
    params: dict
    params_shardings: dict
    batch_shardings: dict
    contracting: dict
    unread: tuple = ()
    serve_sharding: str = "fsdp"


def _logits(cfg, spec, mesh):
    """The logits a prefill or decode returns: [B, S (+ patches), V] in
    the compute dtype, batch over ('pod','data'), vocab over 'model'."""
    seq = 1 if spec["kind"] == "decode" else spec["seq_len"]
    vocab = cfg.padded_vocab if cfg.tie_embeddings else cfg.vocab
    t = torch.empty((spec["global_batch"], seq, vocab), dtype=cfg.cdtype, device=L.META)
    return t, SH.MeshSharding(mesh, SH._fit_spec(P(("pod", "data"), None, "model"),
                                                 t.shape, mesh))


def build_cell(cfg, shape, mesh, opt: bool = False) -> Cell:
    """The meta state and fitted shardings of one cell.  ``shape`` names a
    cell of SHAPES or is such a dict; ``mesh`` is a DeviceMesh or a mapping
    {axis: size}.  opt=True applies the serve-side sharding (TP-only
    decode params when they fit; see policies.tp_only)."""
    spec = shape_spec(shape)
    kind = spec["kind"]
    model = zoo.build(cfg, "meta")
    batch = zoo.input_specs(cfg, spec, model)
    batch_sh = SH.named_sharding_tree(zoo.batch_pspec(cfg, spec, model), mesh, shapes=batch)
    contracting = model.params_contracting()

    if kind == "train":
        opt_ = make_optimizer(cfg.optimizer, warmup_cosine(cfg.max_lr, 100, 10000))
        state = TS.abstract_train_state(model, opt_)
        state_sh = SH.named_sharding_tree(TS.train_state_pspec(model, opt_),
                                          mesh, params=True, shapes=state)
        return Cell(kind, (state, batch), (state_sh, batch_sh), (state,), (state_sh,),
                    state.params, state_sh.params, batch_sh, contracting)

    params = _bf16_params(model)
    pspec = model.params_pspec()
    serve_sharding = "fsdp"
    if opt and kind == "decode":
        tp_bytes = 2 * zoo.param_count(cfg) / SH.mesh_axes(mesh).get("model", 1)
        if tp_bytes < TP_ONLY_HBM_BUDGET:
            pspec = SH.tp_only(pspec)
            serve_sharding = "tp-replicated"
        if cfg.num_experts and cfg.ditto_secondary:
            # Ditto slot-weight placement at plan time: the decode step
            # receives pre-placed per-slot expert weights
            params, pspec, contracting = _place_moe_abstract(cfg, params, pspec,
                                                             contracting)
            serve_sharding += "+moe-placed"
    params_sh = SH.named_sharding_tree(pspec, mesh, params=(serve_sharding == "fsdp"),
                                       shapes=params)
    logits, logits_sh = _logits(cfg, spec, mesh)
    if kind == "prefill":
        outs, out_sh = (logits,), (logits_sh,)
    else:                 # decode: the cache comes back, updated in place
        outs, out_sh = (logits, batch["cache"]), (logits_sh, batch_sh["cache"])
    unread = model.decode_unread if kind == "decode" else ()
    return Cell(kind, (params, batch), (params_sh, batch_sh), outs, out_sh,
                params, params_sh, batch_sh, contracting, unread, serve_sharding)


def train_state_bytes(cfg, shape, mesh=None) -> int:
    """Bytes a device of a training cell's state (step, params, optimizer
    state) on ``mesh``, one device by default: what the card holds once
    ``cfg``'s state of that cell is built."""
    cell = build_cell(cfg, shape, mesh or {"data": 1, "model": 1})
    return AN.shard_bytes(cell.args[0], cell.in_shardings[0])


def place_cell(cell: Cell, mesh) -> int:
    """``distribute_tensor`` every argument leaf onto ``mesh`` (a
    DeviceMesh) with its placements; each local shard must have the
    fitted shape.  Leaves of one shape and placement (a param and its
    moments) are placed once.  Returns the number of placements made."""
    from torch.distributed.tensor import distribute_tensor
    seen = set()

    def place(t, sh):
        key = (tuple(t.shape), sh.placements)
        if key in seen:
            return
        seen.add(key)
        local = distribute_tensor(t, mesh, sh.placements).to_local()
        want = sh.local_shape(t.shape)
        if tuple(local.shape) != want:
            raise ValueError(f"{tuple(t.shape)} as {sh.spec}: shard "
                             f"{tuple(local.shape)}, fitted {want}")

    tree_map(place, cell.args, cell.in_shardings)
    return len(seen)


# ------------------------------------------------------------- collectives

# the expert leaf an MoE layer's all-to-all is charged at, placed or not
_DISPATCH = (MOE.EXPERT_LEAVES[0], MOE.slot_name(MOE.EXPERT_LEAVES[0]))
_BATCH_AXES = ("pod", "data")


def _walk(tree, path=()):
    """(path, leaf) pairs of a dict / named-tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _walk(v, path + (k,))
    elif tree is not None:
        yield path, tree


def _axes_of(spec, dims, axes) -> tuple:
    names = []
    for i in dims:
        if i < len(spec):
            names += SH._clean_entry(spec[i], axes)
    return tuple(names)


def _tokens(cfg, spec, path) -> int:
    """Global tokens a leaf is applied to in one forward: the frames for
    whisper's encoder, the text tokens for the embedding lookup, else every
    position of the (decoder) sequence."""
    gb = spec["global_batch"]
    if spec["kind"] == "decode":
        return gb
    if cfg.family == "encdec" and path[0] == "encoder":
        return gb * cfg.encoder_len
    if path[0] == "embed":
        return gb * (spec["seq_len"] - cfg.num_patches)
    return gb * spec["seq_len"]


def _unused(cell: Cell, path) -> bool:
    """Whether the cell's step leaves the param leaf at ``path`` unread."""
    return any(path[:len(p)] == p for p in cell.unread)


def unused_bytes(cell: Cell) -> int:
    """Bytes a device of the param leaves the cell's step does not read."""
    paths = [path for path, _ in _walk(cell.params)]
    for p in cell.unread:
        if not any(path[:len(p)] == p for path in paths):
            raise KeyError(f"unread subtree {'/'.join(p)} is not in the params")
    shardings = dict(_walk(cell.params_shardings))
    return sum(math.prod(shardings[path].local_shape(t.shape)) * t.element_size()
               for path, t in _walk(cell.params) if _unused(cell, path))


def _trips(cfg, path) -> int:
    """Layers a leaf is stacked over (its leading axis), 1 if none."""
    return {"blocks": cfg.num_periods, "encoder": cfg.encoder_layers,
            "decoder": cfg.num_layers}.get(path[0], 1)


def cell_collectives(cfg, shape, cell: Cell, mesh) -> list:
    """The collectives of one step of ``cell`` by the module's rules (a)-(d)."""
    spec = shape_spec(shape)
    kind, train = spec["kind"], spec["kind"] == "train"
    axes = SH.mesh_axes(mesh)
    tok_sh = cell.batch_shardings["tokens"]
    batch_group = math.prod(axes[a] for a in _axes_of(tok_sh.spec, (0,), axes))
    batch_axes = _axes_of(tok_sh.spec, (0,), axes)
    cd_bytes = cfg.cdtype.itemsize
    passes = 2 if train else 1
    out = []
    shardings = dict(_walk(cell.params_shardings))
    contracting = dict(_walk(cell.contracting))
    model = {"model": axes.get("model", 1)}
    for path, t in _walk(cell.params):
        if _unused(cell, path) or not t.is_floating_point():
            continue
        sh = shardings[path]
        trips = _trips(cfg, path)
        layer = 1 if trips > 1 else 0          # the stacked leading axis
        per_layer = math.prod(sh.local_shape(t.shape)) // trips
        name = "/".join(path)
        fsdp = _axes_of(sh.spec, range(len(sh.spec)),
                        {a: axes[a] for a in axes if a in _BATCH_AXES})
        g = math.prod(axes[a] for a in fsdp)
        if g > 1:                                                       # (a), (b)
            out.append(AN.Collective("all-gather", per_layer * t.element_size() * g, g,
                                     trips * passes, fsdp, name))
            if train:
                out.append(AN.Collective("reduce-scatter", per_layer * 4, g, trips,
                                         fsdp, name))
        elif train and batch_group > 1:                                 # (b)
            out.append(AN.Collective("all-reduce", per_layer * 4, batch_group, trips,
                                     batch_axes, name))
        if not _axes_of(sh.spec, range(len(sh.spec)), model):
            continue                                     # nothing over 'model'
        if path not in contracting:
            raise KeyError(f"{name} is sharded over 'model' ({sh.spec}) and its "
                           "model gives no contracting dims")
        dims = tuple(i + layer for i in contracting[path])
        if _axes_of(sh.spec, dims, model) and axes["model"] > 1:        # (c)
            feats = t.shape[-1]          # every model-contracted leaf ends in d_model
            rows = _tokens(cfg, spec, path) // batch_group
            out.append(AN.Collective("all-reduce", rows * feats * cd_bytes, axes["model"],
                                     trips * passes, ("model",), name))
        if path[-1] in _DISPATCH:                                       # (d)
            if _axes_of(sh.spec, (layer,), model) and axes["model"] > 1:
                t_all = _tokens(cfg, spec, path)
                n = min(cfg.moe_group_size, t_all)
                cap = MOE.uniform_capacity(n, cfg.top_k, cfg.num_experts,
                                           cfg.capacity_factor)
                slots = (t.shape[layer] if path[-1] == _DISPATCH[1]   # S_pad, placed
                         else cfg.num_experts + cfg.ditto_secondary)
                packed = (t_all // n) * slots * cap * cfg.d_model * cd_bytes // batch_group
                out.append(AN.Collective("all-to-all", packed, axes["model"],
                                         trips * 2 * passes, ("model",), name))
    return out


# ------------------------------------------------------------------ a cell

def run_cell(arch: str, shape, multi_pod: bool = False, opt: bool = False,
             mesh=None) -> dict:
    """One cell's record.  ``mesh`` defaults to the production mesh (which
    needs a process group of WORLD ranks, ``fake_process_group``); a
    DeviceMesh also has every leaf placed (``place_cell``), a mapping
    {axis: size} only its shapes fitted."""
    cfg = get(arch)
    shape_name = shape if isinstance(shape, str) else "custom"
    spec = shape_spec(shape)
    rec = {"arch": arch, "shape": shape if isinstance(shape, str) else spec,
           "mesh": "multi" if multi_pod else "single", "kind": spec["kind"]}
    if opt:
        cfg = dataclasses.replace(cfg, vocab_pad_to=16)
        rec["optimizations"] = ["vocab_pad_to=16", "serve_tp_only(when fits)"]
    reason = cell_skip_reason(cfg, shape_name)
    if reason:
        rec.update(status="skip", reason=reason)
        return rec

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    axes = SH.mesh_axes(mesh)
    chips = math.prod(axes.values())
    t0 = time.time()
    cell = build_cell(cfg, spec, mesh, opt=opt)
    placed = place_cell(cell, mesh) if not isinstance(mesh, dict) else 0
    build_s = time.time() - t0
    if opt:
        rec["serve_sharding"] = cell.serve_sharding

    memory = AN.extract_memory(cell.args, cell.in_shardings, cell.outs, cell.out_shardings,
                               unused_bytes=unused_bytes(cell), hbm_bytes=H100.hbm_bytes)
    coll = AN.collective_stats(cell_collectives(cfg, spec, cell, mesh), H100)
    flops = CM.cell_flops(cfg, spec)
    hbytes = CM.cell_bytes(cfg, spec)
    terms = AN.roofline_terms(flops["total"] / chips, hbytes["total"] / chips,
                              coll["bytes_moved_total"], H100,
                              nvlink_coll_bytes=coll["bytes_moved_nvlink"])
    mf = zoo.model_flops(cfg, spec)
    rec.update(
        status="ok", chips=chips, mesh_axes=axes, build_s=round(build_s, 3),
        placements_made=placed, hardware=H100.name,
        cost_source="analytic+spec-collectives",
        cost={"flops_global": flops["total"], "flops_forward_global": flops["forward"],
              "bytes_global": hbytes["total"]},
        memory=memory, collectives=coll, model_flops=mf,
        useful_flops_ratio=mf / flops["total"] if flops["total"] else None,
        roofline={"compute_s": terms.compute_s, "memory_s": terms.memory_s,
                  "collective_s": terms.collective_s,
                  "dominant": terms.dominant, "bound_s": terms.bound_s},
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the serve-side optimization bundle")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = "experiments/dryrun_torch_opt" if args.opt else "experiments/dryrun_torch"

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_root = Path(args.out)
    failures = 0
    with fake_process_group():
        for multi in meshes:
            mesh_name = "multi" if multi else "single"
            sub = out_root / mesh_name
            sub.mkdir(parents=True, exist_ok=True)
            tally = {"ok": 0, "skip": 0, "error": 0}
            largest = 0.0
            for arch in archs:
                for shape_name in shapes:
                    path = sub / f"{arch}__{shape_name}.json"
                    tag = f"{arch} x {shape_name} x {mesh_name}"
                    if path.exists() and not args.force:
                        print(f"[skip existing] {path}")
                        rec = json.loads(path.read_text())
                    else:
                        print(f"[dryrun] {tag} ...", flush=True)
                        try:
                            rec = run_cell(arch, shape_name, multi, opt=args.opt)
                        except Exception as e:  # a failure here is a bug in the port
                            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                                   "status": "error", "error": repr(e),
                                   "traceback": traceback.format_exc()}
                            print(f"[FAIL] {tag}: {e!r}", flush=True)
                        path.write_text(json.dumps(rec, indent=2, default=float))
                    tally[rec["status"]] += 1
                    failures += rec["status"] == "error"
                    if rec["status"] == "ok":
                        r = rec["roofline"]
                        gb = rec["memory"]["resident_argument_bytes"] / 1e9
                        largest = max(largest, gb)
                        print(f"[ok] {tag}: args={gb:.3f} GB/dev "
                              f"dominant={r['dominant']} bound={r['bound_s']:.4f}s "
                              f"useful={rec['useful_flops_ratio']:.3f}", flush=True)
            print(f"mesh {mesh_name}: {tally['ok']} ok, {tally['skip']} skipped, "
                  f"{tally['error']} failed; largest argument bytes a device "
                  f"{largest:.3f} GB of {H100.hbm_bytes / 1e9:.0f}", flush=True)
    print(f"done; {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
