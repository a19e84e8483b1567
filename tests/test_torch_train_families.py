"""Parity of the port's training path with the JAX package's, on the CPU,
for the MoE (moonshot), MLA + MoE (deepseek-v2-lite), SSM (mamba2) and
hybrid (Jamba) families at REDUCED configs in float32.

The JAX package differentiates its one-hot MoE einsums and its SSD with
``jax.grad``; the port's MoE pack and unpack differentiate through
``dispatch.OnehotDispatch`` / ``OnehotCombine``, whose backwards on CPU
tensors are the plain versions, so these tests hold the backward formulas
themselves against JAX.  Batches of 2 x 64 tokens: two dispatch groups of
64 a MoE layer, four SSD chunks of 16.  Tolerances as in
tests/test_torch_train.py: the loss within rtol = 1e-5, every gradient leaf
within rtol = 1e-4, atol = 1e-4 * (1 + max |leaf|); one step's params and
moments within 1e-4, 8-bit moments within one code.  The Functions'
gradients, with dropped tuples and eff = P sentinels: under
``torch.autograd.gradcheck`` in float64; against autograd through ``ref``
in float64 (dx and dpacked exactly, dgate within 1e-12); against
``jax.vjp`` of ``repro.kernels.ref``'s plain pack and unpack in float32
(dx and dpacked exactly, dgate within 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.kernels import dispatch, ref
from repro_torch.train import loop
from repro_torch.tree import tree_leaves, tree_map
from tests.test_torch_train import (_assert_state_close, _batch, _jax, _jax_step, _models,
                                    _port_state, _torch, adamw, jadamw, jschedules,
                                    schedules)

FAMILIES = ("moonshot_v1_16b_a3b", "deepseek_v2_lite_16b", "mamba2_780m",
            "jamba_1_5_large_398b")
SEQ = 64


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_vs_jax(arch):
    """The loss and every gradient leaf against jax.value_and_grad: the
    router, the experts' weights through the selected slots, the shared
    experts and the load-balance term (moonshot), MLA's padded V (deepseek),
    the SSD (mamba2) and Jamba's mamba, attention, dense and MoE layers."""
    jmodel, jparams, model, params = _models(arch)
    batch = _batch(model.cfg, s=SEQ, seed=1)
    (want, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, _jax(batch))
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    got, _ = model.loss_fn(leaves, _torch(batch))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tree_leaves(leaves))
    for g, w in zip(tree_leaves(leaves), jleaves):
        w = np.asarray(w)
        assert g.grad is not None and tuple(g.grad.shape) == w.shape
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * (1 + np.abs(w).max()))


@pytest.mark.parametrize("arch,opt", [("moonshot_v1_16b_a3b", "adamw"),
                                      ("jamba_1_5_large_398b", "adamw8bit")])
def test_train_step_vs_jax(arch, opt):
    """make_train_step (clip 1.0, warmup_cosine) against JAX's: two adamw
    steps of moonshot; one adamw8bit step of Jamba (its config's optimizer),
    whose moments are held within one code of their row."""
    jmodel, jparams, model, params = _models(arch)
    jopt = jadamw.make_optimizer(opt, jschedules.warmup_cosine(1e-3, 1, 4))
    popt = adamw.make_optimizer(opt, schedules.warmup_cosine(1e-3, 1, 4))
    jst, jstep = _jax_step(jmodel, jopt, jparams, None)
    st = _port_state(model, popt, params)
    step = loop.make_train_step(model, popt)
    steps = 1 if opt == "adamw8bit" else 2
    for i in range(steps):
        batch = _batch(model.cfg, s=SEQ, seed=10 + i)
        jst, jm = jstep(jst, _jax(batch))
        st, m = step(st, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(st.step) == int(jst.step) == steps
    _assert_state_close(st, jst, opt)


def _cells(rng, g, t, pe, cap):
    """eff, slot [G, T]: occurrence-rank slots (unique cells, as the MoE
    layer makes them; many past ``cap``), with eff = -1 and the sentinel
    eff = pe dropped, and some slots pushed past capacity."""
    eff = rng.integers(0, pe, (g, t)).astype(np.int32)
    slot = np.stack([np.asarray(jops.occurrence_rank(jnp.asarray(e), pe))
                     for e in eff]).astype(np.int32)
    drop = rng.random((g, t))
    eff[drop < 0.1] = -1
    eff[(drop >= 0.1) & (drop < 0.25)] = pe
    slot[(drop >= 0.25) & (drop < 0.3)] = cap + 3
    return torch.from_numpy(eff), torch.from_numpy(slot)


G, T, PE, CAP, D = 2, 24, 3, 5, 4      # 8 tuples an expert > capacity 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    eff, slot = _cells(rng, G, T, PE, CAP)
    x = torch.from_numpy(rng.standard_normal((G, T, D)))
    packed = torch.from_numpy(rng.standard_normal((G, PE, CAP, D)))
    gate = torch.from_numpy(rng.random((G, T)))
    dy = rng.standard_normal((G, T, D))
    dpacked = rng.standard_normal((G, PE, CAP, D))
    return eff, slot, x, packed, gate, dy, dpacked


def test_inputs_drop_tuples():
    eff, slot, *_ = _inputs(0)
    keep = (eff >= 0) & (eff < PE) & (slot < CAP)
    assert bool((eff == PE).any()) and bool((eff == -1).any())
    assert bool(((eff >= 0) & (eff < PE) & (slot >= CAP)).any())
    assert 0 < int(keep.sum()) < G * T
    cells = (torch.arange(G)[:, None] * PE * CAP + eff * CAP + slot)[keep]
    assert cells.unique().numel() == cells.numel()


@pytest.mark.parametrize("with_gate", [True, False], ids=["gate", "gate_none"])
def test_moe_functions_gradcheck_float64(with_gate):
    """OnehotDispatch and OnehotCombine (through the wrappers under grad)
    under gradcheck in float64: each is linear in its row input, so the
    finite differences are exact to rounding."""
    eff, slot, x, packed, gate, *_ = _inputs(1)
    x, packed, gate = (t.clone().requires_grad_() for t in (x, packed, gate))
    assert torch.autograd.gradcheck(
        lambda v: dispatch.onehot_dispatch(eff, slot, v, PE, CAP), (x,))
    if with_gate:
        assert torch.autograd.gradcheck(
            lambda p, gt: dispatch.onehot_combine(eff, slot, p, gt), (packed, gate))
    else:
        assert torch.autograd.gradcheck(
            lambda p: dispatch.onehot_combine(eff, slot, p, None), (packed,))


@pytest.mark.parametrize("with_gate", [True, False], ids=["gate", "gate_none"])
def test_moe_functions_vs_autograd_through_plain(with_gate):
    """The Functions' gradients against autograd through ref.onehot_dispatch
    / onehot_combine on the same float64 inputs: dx and dpacked exactly
    (pure moves and the same gate product), dgate to 1e-12 (the same row
    dot, summed in the same order or another)."""
    eff, slot, x, packed, gate, dy, dp = _inputs(2)
    dy, dp = torch.from_numpy(dy), torch.from_numpy(dp)
    grads = []
    for dispatch_fn, combine_fn in ((dispatch.onehot_dispatch, dispatch.onehot_combine),
                                    (ref.onehot_dispatch, ref.onehot_combine)):
        xs, ps, gs = (t.clone().requires_grad_() for t in (x, packed, gate))
        dispatch_fn(eff, slot, xs, PE, CAP).backward(dp)
        combine_fn(eff, slot, ps, gs if with_gate else None).backward(dy)
        grads.append((xs.grad, ps.grad, gs.grad))
    (dx, dpk, dg), (dx_w, dpk_w, dg_w) = grads
    assert torch.equal(dx, dx_w) and torch.equal(dpk, dpk_w)
    if with_gate:
        torch.testing.assert_close(dg, dg_w, rtol=1e-12, atol=1e-12)
    else:
        assert dg is None and dg_w is None


def test_moe_functions_vs_jax_vjp():
    """The Functions' gradients against jax.vjp of repro.kernels.ref's plain
    pack and unpack, group by group, in float32: dx and dpacked exactly,
    dgate within 1e-6."""
    eff, slot, x, packed, gate, dy, dp = _inputs(3)
    x, packed, gate = (t.float().requires_grad_() for t in (x, packed, gate))
    dy, dp = dy.astype(np.float32), dp.astype(np.float32)
    dispatch.onehot_dispatch(eff, slot, x, PE, CAP).backward(torch.from_numpy(dp))
    dispatch.onehot_combine(eff, slot, packed, gate).backward(torch.from_numpy(dy))
    for i in range(G):
        e, s = jnp.asarray(eff[i].numpy()), jnp.asarray(slot[i].numpy())
        _, vjp = jax.vjp(lambda v: jref.onehot_dispatch(e, s, v, PE, CAP),
                         jnp.asarray(x[i].detach().numpy()))
        np.testing.assert_array_equal(x.grad[i].numpy(), np.asarray(vjp(dp[i])[0]))
        _, vjp = jax.vjp(lambda p, gt: jref.onehot_combine(e, s, p, gt),
                         jnp.asarray(packed[i].detach().numpy()),
                         jnp.asarray(gate[i].detach().numpy()))
        want_p, want_g = vjp(dy[i])
        np.testing.assert_array_equal(packed.grad[i].numpy(), np.asarray(want_p))
        np.testing.assert_allclose(gate.grad[i].numpy(), np.asarray(want_g), rtol=1e-6,
                                   atol=1e-6)


def test_moe_wrappers_without_grad_skip_the_functions():
    """Under no_grad, and for inputs that need no gradient, the wrappers
    return the plain versions' tensors with no autograd node."""
    eff, slot, x, packed, gate, *_ = _inputs(4)
    x = x.requires_grad_()
    with torch.no_grad():
        got = dispatch.onehot_dispatch(eff, slot, x, PE, CAP)
    assert got.grad_fn is None
    assert torch.equal(got, ref.onehot_dispatch(eff, slot, x.detach(), PE, CAP))
    y = dispatch.onehot_combine(eff, slot, packed, gate)
    assert y.grad_fn is None and torch.equal(y, ref.onehot_combine(eff, slot, packed, gate))
    assert type(dispatch.onehot_dispatch(eff, slot, x, PE, CAP).grad_fn).__name__ \
        == "OnehotDispatchBackward"


def test_unstack_matches_take():
    """The forward's per-period params: ``unstack`` gives the same views as
    ``take`` of each period, and the same gradients bit for bit (one
    stack in place of a zero-filled stack a period, summed)."""
    from repro_torch.models.transformer import take, unstack
    rng = np.random.default_rng(6)
    tree = {"a": torch.from_numpy(rng.standard_normal((5, 3, 4))),
            "b": {"c": torch.from_numpy(rng.standard_normal((5, 7)))}}
    grads = []
    for split in (lambda t: unstack(t, 5), lambda t: [take(t, i) for i in range(5)]):
        leaves = tree_map(lambda t: t.clone().requires_grad_(), tree)
        loss = sum((i + 1) * (pp["a"].sin().sum() + pp["b"]["c"].square().sum())
                   for i, pp in enumerate(split(leaves)))
        loss.backward()
        grads.append([t.grad for t in tree_leaves(leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    for i, pp in enumerate(unstack(tree, 5)):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp),
                                                      tree_leaves(take(tree, i))))


def test_launch_train_moonshot_resumes(tmp_path, capsys):
    """The launcher on REDUCED moonshot (MoE, Ditto slots): 2 steps with a
    checkpoint, then a second run resumes at step 2 and ends at 3, every
    parameter finite."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", "moonshot-v1-16b-a3b", "--reduced", "--batch",
            "2", "--seq", "32", "--log-every", "1", "--ckpt", str(tmp_path)]
    state = train.main(argv + ["--steps", "2"])
    assert int(state.step) == 2
    assert CheckpointManager(tmp_path).latest_step() == 2
    state = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert int(state.step) == 3 and "finished at step 3" in out
    assert "step      2 loss" in out and "step      0 loss" in out
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))
