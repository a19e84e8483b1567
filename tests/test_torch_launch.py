"""The port's dry-run side against the JAX package's: spec trees, their
fitting to the production meshes, shape-only (meta) states, parameter and
FLOP counts, the cost model, the collective arithmetic and the roofline,
the spec-derived collectives against hand counts, the dry run's CLI, and
the per-device argument bytes against JAX's compiled ones
(tools/dryrun_vs_jax.py in a subprocess of 8 host devices).

Every config runs at full size here: the port's states are ``meta``
tensors and JAX's ``ShapeDtypeStruct``s, so nothing is allocated.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jcfgs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import analysis as JAN
from repro.launch import costmodel as JCM
from repro.launch import dryrun_rules as JRULES
from repro.launch.mesh import Hardware as JHardware
from repro.models import moe as JMOE
from repro.models import zoo as JZ
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.schedules import constant as jconstant
from repro.sharding import policies as JSH
from repro.train import state as JTS
from repro_torch import configs as pcfgs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analysis as AN
from repro_torch.launch import costmodel as CM
from repro_torch.launch import dryrun as D
from repro_torch.launch import dryrun_rules as RULES
from repro_torch.launch.mesh import H100
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import zoo as Z
from repro_torch.optim import constant, make_optimizer
from repro_torch.sharding import policies as SH
from repro_torch.sharding.policies import P
from repro_torch.train import state as TS

REPO = Path(__file__).resolve().parents[1]
ARCHS = pcfgs.ARCH_IDS
MOE_ARCHS = [a for a in ARCHS if pcfgs.get(a).num_experts]
OPTIMIZERS = ("adamw", "adamw8bit")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}


class FakeMesh:
    """What JAX's policies read of a mesh: axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


# ----------------------------------------------------------------- helpers

def _is_spec(x) -> bool:
    return isinstance(x, (JP, P))


def flat(tree, path: str = "") -> dict:
    """{leaf path: leaf} of a tree of dicts, named tuples and dataclasses
    (either package's), a spec as the tuple of its entries, a tensor or
    ShapeDtypeStruct as (shape, dtype name)."""
    if _is_spec(tree):
        return {path: tuple(tree)}
    if tree is None:
        return {path: None}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{path}/{k}"))
    return out


@functools.lru_cache(maxsize=None)
def jcfg(arch):
    return jcfgs.get(arch)


@functools.lru_cache(maxsize=None)
def pcfg(arch):
    return pcfgs.get(arch)


@functools.lru_cache(maxsize=None)
def jax_param_shapes(arch):
    model = JZ.build(jcfg(arch))
    return jax.eval_shape(model.init_params, jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return Z.build(pcfg(arch), "meta").init_params(L.ShapeOnly())


def jax_state(arch, opt):
    o = jmake_optimizer(opt, jconstant(1e-3))
    model = JZ.build(jcfg(arch))
    return JTS.train_state_pspec(model, o), JTS.abstract_train_state(model, o)


def port_state(arch, opt):
    o = make_optimizer(opt, constant(1e-3))
    model = Z.build(pcfg(arch), "meta")
    return TS.train_state_pspec(model, o), TS.abstract_train_state(model, o)


# -------------------------------------------------------------- spec trees

@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_pspec_equal_jax(arch):
    jm, pm = JZ.build(jcfg(arch)), Z.build(pcfg(arch), "meta")
    assert flat(pm.params_pspec()) == flat(jm.params_pspec())
    assert flat(pm.cache_pspec()) == flat(jm.cache_pspec())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspec_equals_jax(arch, shape):
    assert flat(Z.batch_pspec(pcfg(arch), shape)) == flat(JZ.batch_pspec(jcfg(arch), shape))


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_pspec_and_shapes_equal_jax(arch, opt):
    (jspec, jstate), (pspec, pstate) = jax_state(arch, opt), port_state(arch, opt)
    assert flat(pspec) == flat(jspec)
    assert flat(pstate) == flat(jstate)
    assert {t.device for t in flat_tensors(pstate.opt_state)} == {L.META}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_slot_weights_pspec_equals_jax(arch):
    n = pcfg(arch).num_shared_experts
    assert (flat(MOE.slot_weights_pspec(MOE.moe_pspec(n)))
            == flat(JMOE.slot_weights_pspec(JMOE.moe_pspec(n))))


def test_spec_normalizes_as_jax():
    for entries in (("data", ("model",), None, ("data", "pod")), ((),), (["a", "b"],), ()):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P(("data",)) == P("data") and P(None) != P()


# ------------------------------------------------------- shape-only states

@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_equal_jax_eval_shape(arch):
    """The shape-only params of the full config: JAX's eval_shape leaf by
    leaf, every leaf on meta (nothing allocated)."""
    got = port_params(arch)
    assert flat(got) == flat(jax_param_shapes(arch))
    assert {t.device for t in flat_tensors(got)} == {L.META}


def flat_tensors(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch, shape):
    assert flat(Z.input_specs(pcfg(arch), shape)) == flat(JZ.input_specs(jcfg(arch), shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_only_init_matches_a_real_one(arch):
    """At REDUCED size the meta params have the CPU init's shapes and dtypes."""
    cfg = pcfgs.get_reduced(arch)
    cpu = Z.build(cfg, "cpu")
    assert (flat(Z.build(cfg, "meta").init_params(L.ShapeOnly()))
            == flat(cpu.init_params(cpu.generator(0))))


# ------------------------------------------------------- fitting to meshes

def _fit_pairs(spec_tree, shapes):
    specs, leaves = flat(spec_tree), flat(shapes)
    assert specs.keys() == leaves.keys()
    return [(k, specs[k], leaves[k][0]) for k in specs if specs[k] is not None]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fit_promote_and_tp_only_equal_jax(arch, mesh):
    """Every params (promoted, and TP-only), train-state (adamw8bit too),
    batch and cache leaf of the full config, fitted to the mesh."""
    axes = MESHES[mesh]
    fake = FakeMesh(axes)
    jm, pm = JZ.build(jcfg(arch)), Z.build(pcfg(arch), "meta")
    trees = [(JSH.promote_fsdp(jm.params_pspec(), fake), SH.promote_fsdp(pm.params_pspec(), axes),
              jax_param_shapes(arch)),
             (JSH.tp_only(jm.params_pspec()), SH.tp_only(pm.params_pspec()),
              jax_param_shapes(arch))]
    for opt in OPTIMIZERS:
        jspec, jstate = jax_state(arch, opt)
        pspec, _ = port_state(arch, opt)
        trees.append((JSH.promote_fsdp(jspec, fake), SH.promote_fsdp(pspec, axes), jstate))
    for shape in ("train_4k", "decode_32k"):
        trees.append((JZ.batch_pspec(jcfg(arch), shape), Z.batch_pspec(pcfg(arch), shape),
                      JZ.input_specs(jcfg(arch), shape)))
    n = 0
    for jspec, pspec, shapes in trees:
        assert flat(pspec) == flat(jspec)
        pflat = flat(pspec)
        for path, spec, shape in _fit_pairs(jspec, shapes):
            want = tuple(JSH._fit_spec(JP(*spec), shape, fake))
            got = SH._fit_spec(P(*pflat[path]), shape, axes)
            assert tuple(got) == want, (path, shape, got, want)
            n += 1
    assert n > 50


def test_fit_spec_cases():
    mesh3 = MESHES["2x16x16"]
    assert SH._fit_spec(P("data", "model"), (32, 64), MESHES["16x16"]) == P("data", "model")
    assert SH._fit_spec(P(None, "model", None), (4, 8, 64), MESHES["16x16"]) == P(None, None, None)
    assert SH._fit_spec(P(("data", "pod")), (40,), mesh3) == P(None)
    assert SH._fit_spec(P(("data", "pod")), (64,), mesh3) == P(("data", "pod"))
    assert SH._fit_spec(P(("pod", "data"), None), (1, 128), mesh3) == P(None, None)
    assert SH._fit_spec(P("expert"), (16,), MESHES["16x16"]) == P(None)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    axes = MESHES["2x32x8"]
    sh = SH.MeshSharding(axes, P(("data", "pod"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert sh.local_shape((128, 64)) == (2, 8)
    assert SH.replicated(axes).placements == (Replicate(),) * 3
    with pytest.raises(ValueError):
        SH.MeshSharding(axes, P("model")).local_shape((12,))


def test_production_meshes_on_a_fake_process_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with D.fake_process_group():
        single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
        assert SH.mesh_axes(single) == {"data": 32, "model": 8}
        assert SH.mesh_axes(multi) == {"pod": 2, "data": 32, "model": 8}
        assert SH.mesh_axes(make_host_mesh(2, 4)) == {"data": 2, "model": 4}
    assert not dist.is_initialized()


def test_hardware_is_the_h100():
    assert H100.name.startswith("NVIDIA H100 80GB HBM3")
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes, H100.link_bw) == \
        (989.4e12, 3.35e12, 80e9, 50e9)
    assert (H100.nvlink_bw, H100.nvlink_axes) == (450e9, ("model",))
    assert D.TP_ONLY_HBM_BUDGET == 30e9


# ------------------------------------------------------- counts and costs

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_model_flops_and_skips_equal_jax(arch):
    p, j = pcfg(arch), jcfg(arch)
    assert Z.param_count(p) == JZ.param_count(j)
    assert Z.active_param_count(p) == JZ.active_param_count(j)
    for shape in SHAPES:
        assert Z.model_flops(p, shape) == JZ.model_flops(j, shape)
        assert RULES.cell_skip_reason(p, shape) == JRULES.cell_skip_reason(j, shape)
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_jax_without_remat_and_onehot(arch, shape):
    """cell_flops against JAX's with moe_impl="sort" (the pack and unpack
    are copies) and remat="none" on both sides; cell_bytes exact."""
    ref = dataclasses.replace(jcfg(arch), moe_impl="sort", remat="none")
    cfg = dataclasses.replace(pcfg(arch), remat="none")
    got, want = CM.cell_flops(cfg, shape), JCM.cell_flops(ref, shape)
    for k in ("forward", "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)
    assert CM.cell_bytes(cfg, shape) == JCM.cell_bytes(jcfg(arch), shape)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_jax_with_remat(arch, shape, remat):
    """cell_flops against JAX's at the same remat (moe_impl="sort"): "full"
    adds one forward to a training step, "dots" none; cell_bytes exact."""
    ref = dataclasses.replace(jcfg(arch), moe_impl="sort", remat=remat)
    cfg = dataclasses.replace(pcfg(arch), remat=remat)
    got, want = CM.cell_flops(cfg, shape), JCM.cell_flops(ref, shape)
    for k in ("forward", "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)
    assert CM.cell_bytes(cfg, shape) == JCM.cell_bytes(ref, shape)


def test_cost_model_takes_a_measured_shape():
    cfg = dataclasses.replace(pcfgs.get("llama3.2-3b"), num_layers=4)
    spec = dict(kind="train", seq_len=1024, global_batch=2)
    fwd = CM.forward_flops_per_token(cfg, "train", 1024) * 2048
    assert cfg.remat == "full"            # the backward recomputes one forward
    assert CM.cell_flops(cfg, spec) == {"forward": fwd,
                                        "total": 4 * fwd + 10 * Z.param_count(cfg)}
    assert CM.cell_flops(dataclasses.replace(cfg, remat="none"), spec)["total"] == \
        3 * fwd + 10 * Z.param_count(cfg)


# ------------------------------------------- collective arithmetic, roofline

@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32, 256, 512])
@pytest.mark.parametrize("kind", AN.COLLECTIVE_KINDS)
def test_moved_bytes_equal_jax(kind, group):
    for result in (0, 1, 4096, 3 * 2**20):
        assert AN._moved_bytes(kind, result, group) == JAN._moved_bytes(kind, result, group)


HLO = """
HloModule test

%body.1 (arg: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %ag = f32[128,256]{1,0} all-gather(f32[8,256]{1,0} %x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[128]{0} all-reduce(f32[128]{0} %y), replica_groups={{0,1,2,3}}, to_apply=%add
}

ENTRY %main (p0: f32[128,256]) -> f32[128,256] {
  %w = (s32[], f32[128,256]) while((s32[], f32[128,256]) %init), condition=%cond.1, body=%body.1
  %rs = f32[8,256]{1,0} reduce-scatter(f32[128,256]{1,0} %z), replica_groups=[16,16]<=[256], dimensions={0}
  %a2a = bf16[64,32]{1,0} all-to-all(bf16[64,32]{1,0} %u), replica_groups=[32,8]<=[256], dimensions={0}
  %cp = f32[64]{0} collective-permute(f32[64]{0} %q), source_target_pairs={{0,1}}
}
"""


def test_collective_stats_equal_parse_collectives():
    """The same collectives as records and as HLO text give the same dict."""
    records = [AN.Collective("all-gather", 128 * 256 * 4, 16, 10),
               AN.Collective("all-reduce", 128 * 4, 4, 10),
               AN.Collective("reduce-scatter", 8 * 256 * 4, 16),
               AN.Collective("all-to-all", 64 * 32 * 2, 8),
               AN.Collective("collective-permute", 64 * 4, 256)]
    want = JAN.parse_collectives(HLO, world=256, body_trip=10)
    got = AN.collective_stats(records)
    assert got["per_kind"] == want["per_kind"]
    assert got["bytes_moved_total"] == want["bytes_moved_total"]


@pytest.mark.parametrize("terms", [(1e12, 1e9, 1e6), (1e9, 1e12, 0.0), (0.0, 0.0, 1e12),
                                   (5e15, 2e12, 3e10)])
def test_roofline_terms_equal_jax(terms):
    jhw = JHardware(name="h100", peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw,
                    ici_bw=H100.link_bw, hbm_bytes=H100.hbm_bytes)
    got, want = AN.roofline_terms(*terms, H100), JAN.roofline_terms(*terms, jhw)
    assert (got.compute_s, got.memory_s, got.collective_s, got.dominant, got.bound_s) == \
        (want.compute_s, want.memory_s, want.collective_s, want.dominant, want.bound_s)


@pytest.mark.parametrize("axes,nvlink", [(("model",), True), (("data",), False),
                                         (("pod", "data"), False),
                                         (("data", "model"), False), ((), False)])
def test_collective_stats_split_by_link(axes, nvlink):
    """A record stays on NVLink only when every axis it spans does; the
    roofline adds the two links' times."""
    records = [AN.Collective("all-reduce", 1e6, 8, 3, axes),
               AN.Collective("all-gather", 4e6, 32, 1, ("data",))]
    stats = AN.collective_stats(records, H100)
    ar = 2.0 * 7 / 8 * 1e6 * 3
    ag = 31 / 32 * 4e6
    assert stats["bytes_moved_total"] == ar + ag
    assert stats["bytes_moved_nvlink"] == (ar if nvlink else 0.0)
    t = AN.roofline_terms(0.0, 0.0, stats["bytes_moved_total"], H100,
                          nvlink_coll_bytes=stats["bytes_moved_nvlink"])
    want = (ag / 50e9 + ar / 450e9) if nvlink else (ar + ag) / 50e9
    assert t.collective_s == pytest.approx(want, rel=1e-15)


def _paths(tree, path=()):
    return {p for p, _ in D._walk(tree, path)}


@pytest.mark.parametrize("arch", ARCHS)
def test_contracting_dims_cover_every_model_sharded_leaf(arch):
    """Each model's contracting tree names only its weight leaves and holds
    an entry for every leaf its spec shards over 'model'; the entries'
    dims exist in one layer's layout.  decode_unread names real subtrees."""
    model = Z.build(pcfg(arch), "meta")
    params = dict(D._walk(port_params(arch)))
    specs = dict(D._walk(model.params_pspec()))
    contracting = dict(D._walk(model.params_contracting()))
    assert set(contracting) <= set(params)
    stacked = {"blocks", "encoder", "decoder"}
    for path, spec in specs.items():
        if "model" in str(tuple(spec)):
            assert path in contracting, path
    for path, dims in contracting.items():
        ndim = params[path].dim() - (path[0] in stacked)
        assert all(0 <= i < ndim for i in dims), (path, dims)
    for prefix in model.decode_unread:
        assert any(p[:len(prefix)] == prefix for p in params), prefix


def test_model_sharded_leaf_without_contracting_dims_fails_the_cell():
    cfg = pcfgs.get_reduced("llama3.2-3b")
    shape = dict(kind="prefill", seq_len=64, global_batch=4)
    cell = D.build_cell(cfg, shape, HAND_MESH)
    del cell.contracting["blocks"]["0.mixer"]["wo"]
    with pytest.raises(KeyError, match="0.mixer/wo"):
        D.cell_collectives(cfg, shape, cell, HAND_MESH)


def test_unread_subtree_missing_from_params_fails():
    cfg = pcfgs.get_reduced("whisper-base")
    cell = D.build_cell(cfg, dict(kind="decode", seq_len=64, global_batch=4), HAND_MESH)
    assert D.unused_bytes(cell) > 0
    cell.unread = cell.unread + (("decoder", "no_such_leaf"),)
    with pytest.raises(KeyError, match="no_such_leaf"):
        D.unused_bytes(cell)


# ---------------------------------------------- spec collectives, by hand

HAND_MESH = {"data": 2, "model": 4}


def hand_llama(kind):
    """Records (kind, result bytes, group, trips, mesh axes, leaf) of
    REDUCED llama3.2-3b (d 64, 4 heads of 16 over 2 KV heads, d_ff 128,
    vocab 256, 2 layers, float32) at [4, 64] on (data 2, model 4): the
    batch splits 2-way, so 128 tokens a device (2 at decode).  Shards a
    device: emb [64, 32] (8192 B), wq/wo a layer [32, 1, 16] (2048 B),
    wk/wv [32, 2, 16] (model 4 does not divide 2 KV heads: 4096 B), the
    MLP's three [32, 32] (4096 B); norms replicated."""
    train = kind == "train"
    passes = 2 if train else 1
    rows = {"train": 128, "prefill": 128, "decode": 2}[kind]
    out = [("all-gather", 8192 * 2, 2, passes, ("data",), "embed/emb"),
           ("all-reduce", rows * 64 * 4, 4, passes, ("model",), "embed/emb")]
    for name, local in (("0.mixer/wq", 2048), ("0.mixer/wk", 4096), ("0.mixer/wv", 4096),
                        ("0.mixer/wo", 2048), ("0.ffn/up/w", 4096), ("0.ffn/down/w", 4096),
                        ("0.ffn/gate/w", 4096)):
        out.append(("all-gather", local * 2, 2, 2 * passes, ("data",), f"blocks/{name}"))
        if train:
            out.append(("reduce-scatter", local, 2, 2, ("data",), f"blocks/{name}"))
        if name in ("0.mixer/wo", "0.ffn/down/w"):
            out.append(("all-reduce", rows * 64 * 4, 4, 2 * passes, ("model",),
                        f"blocks/{name}"))
    if train:
        out.append(("reduce-scatter", 8192, 2, 1, ("data",), "embed/emb"))
        out += [("all-reduce", 64 * 4, 2, 2, ("data",), "blocks/0.norm1/scale"),
                ("all-reduce", 64 * 4, 2, 2, ("data",), "blocks/0.norm2/scale"),
                ("all-reduce", 64 * 4, 2, 1, ("data",), "final_norm/scale")]
    return out


def hand_moonshot(kind):
    """REDUCED moonshot (as llama, 4 KV heads; 8 experts of d_ff 32 + 4
    Ditto slots, top-2, one shared expert of d_ff 64, groups of 64
    tokens).  Shards: wq..wo [32, 1, 16] (2048 B), experts [2, 32, 32]
    (8192 B), the shared MLP [32, 16] (2048 B), the router [64, 8]
    replicated (2048 B).  The dispatch: 256 tokens in 4 groups of 64,
    capacity max(4, int(1.25 * 64 * 2 / 8)) = 20, 12 slots: 2 groups a
    device, 2 * 12 * 20 * 64 * 4 B = 122880 B each way a layer."""
    train = kind == "train"
    passes = 2 if train else 1
    out = [("all-gather", 8192 * 2, 2, passes, ("data",), "embed/emb"),
           ("all-reduce", 128 * 64 * 4, 4, passes, ("model",), "embed/emb"),
           ("all-to-all", 122880, 4, 2 * 2 * passes, ("model",), "blocks/0.ffn/up")]
    for name, local in (("0.mixer/wq", 2048), ("0.mixer/wk", 2048), ("0.mixer/wv", 2048),
                        ("0.mixer/wo", 2048), ("0.ffn/up", 8192), ("0.ffn/gate", 8192),
                        ("0.ffn/down", 8192), ("0.ffn/shared/up/w", 2048),
                        ("0.ffn/shared/down/w", 2048), ("0.ffn/shared/gate/w", 2048)):
        out.append(("all-gather", local * 2, 2, 2 * passes, ("data",), f"blocks/{name}"))
        if train:
            out.append(("reduce-scatter", local, 2, 2, ("data",), f"blocks/{name}"))
        if name in ("0.mixer/wo", "0.ffn/shared/down/w"):
            out.append(("all-reduce", 128 * 64 * 4, 4, 2 * passes, ("model",),
                        f"blocks/{name}"))
    if train:
        out.append(("reduce-scatter", 8192, 2, 1, ("data",), "embed/emb"))
        out += [("all-reduce", 64 * 4, 2, 2, ("data",), "blocks/0.norm1/scale"),
                ("all-reduce", 64 * 4, 2, 2, ("data",), "blocks/0.norm2/scale"),
                ("all-reduce", 64 * 8 * 4, 2, 2, ("data",), "blocks/0.ffn/router"),
                ("all-reduce", 64 * 4, 2, 1, ("data",), "final_norm/scale")]
    return out


@pytest.mark.parametrize("arch,kind,hand", [
    ("llama3.2-3b", "train", hand_llama), ("llama3.2-3b", "prefill", hand_llama),
    ("llama3.2-3b", "decode", hand_llama), ("moonshot-v1-16b-a3b", "train", hand_moonshot),
    ("moonshot-v1-16b-a3b", "prefill", hand_moonshot)])
def test_spec_collectives_equal_hand_counts(arch, kind, hand):
    cfg = pcfgs.get_reduced(arch)
    shape = dict(kind=kind, seq_len=64, global_batch=4)
    cell = D.build_cell(cfg, shape, HAND_MESH)
    got = sorted(tuple(r) for r in D.cell_collectives(cfg, shape, cell, HAND_MESH))
    assert got == sorted(hand(kind))


# ----------------------------------------------------------- the dry run

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def dryrun_all(tmp_path_factory):
    """The CLI over every arch, shape and both meshes, in a process of its
    own (the fake process group is global), with its peak RSS."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    code = ("import resource, sys\n"
            "from repro_torch.launch.dryrun import main\n"
            f"rc = main(['--arch', 'all', '--shape', 'all', '--mesh', 'both', '--out', {str(out)!r}])\n"
            "print('maxrss_kb', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=600)
    return proc, out


def test_dryrun_cli_covers_every_cell(dryrun_all):
    proc, out = dryrun_all
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    n = 0
    for mesh, chips in (("single", 256), ("multi", 512)):
        for arch in D.ARCHS:
            for shape in SHAPES:
                rec = json.loads((out / mesh / f"{arch}__{shape}.json").read_text())
                reason = JRULES.cell_skip_reason(jcfgs.get(arch), shape)
                if reason:
                    assert shape == "long_500k" and rec["status"] == "skip"
                    assert rec["reason"] == reason
                    continue
                assert rec["status"] == "ok", rec
                assert rec["chips"] == chips and rec["placements_made"] > 0
                assert rec["cost_source"] == "analytic+spec-collectives"
                assert rec["memory"]["fits_hbm"]
                assert rec["roofline"]["bound_s"] > 0
                n += 1
    assert n == 2 * 32


def test_dryrun_allocates_no_full_config(dryrun_all):
    """jamba-398B's state alone is terabytes: the run stays under 4 GB."""
    proc, _ = dryrun_all
    kb = int(proc.stdout.split("maxrss_kb")[-1].split()[0])
    assert kb < 4 * 2**20, kb


def test_dryrun_mesh_lines(dryrun_all):
    proc, _ = dryrun_all
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("mesh ")]
    assert lines == [ln for ln in lines if "32 ok, 8 skipped, 0 failed" in ln]
    assert len(lines) == 2


def test_opt_cell_places_moe_slots():
    """--opt decode: TP-only params where they fit, Ditto's placed slots."""
    cfg = dataclasses.replace(pcfgs.get("deepseek-v2-lite-16b"), vocab_pad_to=16)
    cell = D.build_cell(cfg, "decode_32k", MESHES["32x8"], opt=True)
    assert cell.serve_sharding == "tp-replicated+moe-placed"
    ffn = cell.params["blocks"]["1.ffn"] if "1.ffn" in cell.params["blocks"] else \
        cell.params["blocks"]["0.ffn"]
    slots = -(-(cfg.num_experts + cfg.ditto_secondary) // 16) * 16
    assert ffn["up_slots"].shape[:2] == (cfg.num_periods, slots)
    assert ffn["slot_assignment"].shape == (cfg.num_periods, cfg.ditto_secondary)
    specs = {tuple(sh.spec) for sh in flat_tensors(cell.params_shardings)}
    assert not any("data" in str(s) for s in specs)


# ------------------------------------- per-device bytes against compiled JAX

@pytest.fixture(scope="module")
def against_jax():
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "dryrun_vs_jax.py"), "--json"],
                          env=_env(), cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return {(r["arch"], r["kind"]): r for r in json.loads(proc.stdout.splitlines()[-1])}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "moonshot-v1-16b-a3b", "whisper-base"])
def test_argument_bytes_equal_jax_compiled(against_jax, arch, kind):
    """Per-device argument bytes on a fake 8-rank (2, 4) mesh against JAX's
    compiled memory_analysis on an Auto (2, 4) mesh of 8 host devices."""
    row = against_jax[(arch, kind)]
    assert row["port"]["argument_bytes"] == row["jax"]["argument_bytes"]
