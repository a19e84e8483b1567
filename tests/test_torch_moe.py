"""Parity of the port's MoE path with the JAX package's, on the CPU.

The plain dispatch/combine (``repro_torch.kernels.ref``, reached through
``dispatch`` for CPU tensors) against ``repro.kernels.ref`` applied per
group, and against the Pallas kernels in interpret mode at one tiny shape;
``occurrence_rank``; ``moe_apply`` on the reduced moonshot config
against the JAX ``moe_apply`` under ``moe_impl`` "onehot" and "kernel";
and ``place_slot_weights`` (identical placed tensors) with the placed
``moe_apply`` against JAX's placed call and the port's live path (1e-5).
Inputs come from numpy with a seed.  Unique cells must match exactly
(a one-hot product adds one nonzero term); duplicates and the MoE output
use rtol = atol = 1e-4 in float32 (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.moonshot_v1_16b_a3b import REDUCED as JAX_REDUCED
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.moe_onehot import onehot_combine as pallas_combine
from repro.kernels.moe_onehot import onehot_dispatch as pallas_dispatch
from repro.models import moe as jmoe
from repro_torch.configs.moonshot_v1_16b_a3b import REDUCED
from repro_torch.interop import tree_from_numpy
from repro_torch.kernels import dispatch, ops
from repro_torch.models import moe


def _cells(rng, g, t, pe, cap, unique):
    """eff, slot [G, T]: the occurrence rank (unique cells) or random slots
    (duplicates), with dropped tuples: eff = -1, eff = pe and slot >= cap."""
    eff = rng.integers(0, pe, (g, t)).astype(np.int32)
    if unique:
        slot = np.stack([np.asarray(jops.occurrence_rank(jnp.asarray(e), pe))
                         for e in eff]).astype(np.int32)
    else:
        slot = rng.integers(0, cap, (g, t)).astype(np.int32)
    drop = rng.random((g, t))
    eff[drop < 0.05] = -1
    eff[(drop >= 0.05) & (drop < 0.1)] = pe
    slot[(drop >= 0.1) & (drop < 0.15)] = cap + 3
    return eff, slot


def _per_group(fn, *arrays):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(arrays[0].shape[0])])


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("g,t,pe,cap,dim", [(1, 256, 8, 40, 128), (3, 100, 4, 16, 64),
                                            (2, 9, 2, 8, 32)])
def test_dispatch_vs_jax_ref(g, t, pe, cap, dim, unique):
    rng = np.random.default_rng(g * 1000 + t + unique)
    eff, slot = _cells(rng, g, t, pe, cap, unique)
    x = rng.standard_normal((g, t, dim)).astype(np.float32)
    got = dispatch.onehot_dispatch(torch.from_numpy(eff), torch.from_numpy(slot),
                                   torch.from_numpy(x), pe, cap).numpy()
    want = _per_group(lambda e, s, v: jref.onehot_dispatch(e, s, v, pe, cap),
                      eff, slot, x)
    assert got.shape == (g, pe, cap, dim)
    if unique:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_gate", [True, False])
@pytest.mark.parametrize("g,t,pe,cap,dim", [(1, 256, 8, 64, 128), (2, 64, 4, 32, 96)])
def test_combine_vs_jax_ref(g, t, pe, cap, dim, with_gate):
    rng = np.random.default_rng(t + dim + with_gate)
    eff, slot = _cells(rng, g, t, pe, cap, unique=False)
    packed = rng.standard_normal((g, pe, cap, dim)).astype(np.float32)
    gate = rng.random((g, t)).astype(np.float32)
    got = dispatch.onehot_combine(
        torch.from_numpy(eff), torch.from_numpy(slot), torch.from_numpy(packed),
        torch.from_numpy(gate) if with_gate else None).numpy()
    if with_gate:
        want = _per_group(jref.onehot_combine, eff, slot, packed, gate)
    else:
        want = _per_group(jref.onehot_combine, eff, slot, packed)
    np.testing.assert_array_equal(got, want)


def test_dispatch_combine_vs_pallas_interpret():
    """One tiny shape through the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(5)
    t, pe, cap, dim = 16, 4, 8, 32
    eff, slot = _cells(rng, 1, t, pe, cap, unique=True)
    x = rng.standard_normal((1, t, dim)).astype(np.float32)
    gate = rng.random((1, t)).astype(np.float32)
    packed = dispatch.onehot_dispatch(torch.from_numpy(eff), torch.from_numpy(slot),
                                      torch.from_numpy(x), pe, cap)
    want = pallas_dispatch(jnp.asarray(eff[0]), jnp.asarray(slot[0]),
                           jnp.asarray(x[0]), pe, cap, interpret=True)
    np.testing.assert_allclose(packed[0].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    y = dispatch.onehot_combine(torch.from_numpy(eff), torch.from_numpy(slot), packed,
                                torch.from_numpy(gate))
    want = pallas_combine(jnp.asarray(eff[0]), jnp.asarray(slot[0]), want,
                          jnp.asarray(gate[0]), interpret=True)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g,t,pe", [(1, 200, 6), (4, 300, 72), (2, 7, 3)])
def test_occurrence_rank_vs_jax(g, t, pe):
    eff = np.random.default_rng(t).integers(0, pe, (g, t)).astype(np.int32)
    got = ops.occurrence_rank(torch.from_numpy(eff), pe).numpy()
    want = _per_group(lambda e: jops.occurrence_rank(e, pe), eff)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [None, 4])
@pytest.mark.parametrize("num_sec", [0, 4])
@pytest.mark.parametrize("impl", ["onehot", "kernel"])
def test_moe_apply_vs_jax(impl, num_sec, capacity):
    """Reduced moonshot MoE (8 experts top-2, 1 shared, group 64) over two
    dispatch groups; capacity 4 forces drops.  The same weights and input."""
    cfg = JAX_REDUCED
    jparams = jmoe.moe_params(jax.random.PRNGKey(num_sec), cfg.d_model, cfg.moe_d_ff,
                              cfg.num_experts, jnp.float32, cfg.num_shared_experts,
                              cfg.shared_d_ff)
    x = np.random.default_rng(11).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, num_secondary=num_sec,
              group_size=cfg.moe_group_size, capacity=capacity)
    want_y, want_aux = jmoe.moe_apply(jparams, jnp.asarray(x), impl=impl, **kw)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), torch.device("cpu"))
    y, aux = moe.moe_apply(params, torch.from_numpy(x), **kw)
    assert REDUCED.compute_dtype == cfg.compute_dtype == "float32"
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-4)
    assert set(aux) == set(want_aux)
    for key in ("max_designated_load", "max_slot_load"):
        assert int(aux[key]) == int(want_aux[key]), key
    for key in ("lb_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=1e-6,
                                   err_msg=key)
    if capacity == 4:
        assert float(aux["drop_frac"]) > 0


def test_moe_apply_ditto_balances_skew():
    """A router skewed to expert 0: with X = 4 the hottest slot carries less
    than the hottest expert's designated load (the paper's Fig. 2b cure)."""
    cfg = REDUCED
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts)
    params["router"][:, 0] += 0.5
    x = torch.randn((2, 64, cfg.d_model), generator=gen).abs()
    _, aux = moe.moe_apply(params, x, num_experts=cfg.num_experts, top_k=cfg.top_k,
                           num_secondary=4, group_size=cfg.moe_group_size)
    assert int(aux["max_slot_load"]) < int(aux["max_designated_load"])


def _placement_case():
    """tests/test_opt_variants.py's placement case (8 experts top-2, X = 3,
    1 shared, group 64, two groups) in both packages: JAX's weights and
    input, the plan the live path derives from the batch's histogram,
    placed with pad_to = 4 (S_pad = 12 slots)."""
    from repro.core.scheduler import schedule_secpes
    e, k, d, ff, x_sec = 8, 2, 32, 64, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    jparams = jmoe.moe_params(k1, d, ff, e, num_shared=1, shared_d_ff=64)
    x = np.array(jax.random.normal(k2, (2, 64, d)))
    ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x).reshape(-1, d) @ jparams["router"],
                                       -1), k)[1]
    assignment = schedule_secpes(jnp.sum(jax.nn.one_hot(ids, e, dtype=jnp.int32),
                                         axis=(0, 1)), x_sec)
    kw = dict(num_experts=e, top_k=k, num_secondary=x_sec, group_size=64)
    return jparams, x, np.array(assignment), kw


def test_place_slot_weights_vs_jax():
    jparams, _, assignment, kw = _placement_case()
    want = jmoe.place_slot_weights(jparams, jnp.asarray(assignment), kw["num_experts"],
                                   pad_to=4)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), torch.device("cpu"))
    got = moe.place_slot_weights(params, torch.from_numpy(assignment), kw["num_experts"],
                                 pad_to=4)
    assert set(got) == set(want)
    assert got["up_slots"].shape[0] == 12
    for name in ("up_slots", "gate_slots", "down_slots", "slot_assignment"):
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("impl", ["onehot", "kernel"])
def test_placed_moe_apply_vs_jax_and_live(impl, monkeypatch):
    """The placed call against JAX's placed call and against the port's
    live path on the same batch (whose plan it fixed), within 1e-5; its
    pack and unpack run at P = S_pad = 12 slots."""
    jparams, x, assignment, kw = _placement_case()
    jplaced = jmoe.place_slot_weights(jparams, jnp.asarray(assignment), kw["num_experts"],
                                      pad_to=4)
    want_y, want_aux = jmoe.moe_apply(jplaced, jnp.asarray(x), impl=impl, **kw)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), torch.device("cpu"))
    placed = moe.place_slot_weights(params, torch.from_numpy(assignment),
                                    kw["num_experts"], pad_to=4)
    seen = []
    real = dispatch.onehot_dispatch
    monkeypatch.setattr(dispatch, "onehot_dispatch",
                        lambda *a: seen.append(a[3]) or real(*a))
    y, aux = moe.moe_apply(placed, torch.from_numpy(x), **kw)
    assert seen == [12]
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    for key in ("max_designated_load", "max_slot_load"):
        assert int(aux[key]) == int(want_aux[key]), key
    np.testing.assert_allclose(float(aux["drop_frac"]), float(want_aux["drop_frac"]),
                               atol=1e-6)
    y_live, aux_live = moe.moe_apply(params, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(y.numpy(), y_live.numpy(), rtol=1e-5, atol=1e-5)
    assert abs(float(aux["drop_frac"]) - float(aux_live["drop_frac"])) < 1e-6
