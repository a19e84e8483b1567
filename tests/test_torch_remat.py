"""Activation checkpointing (``ArchConfig.remat``) on the CPU, at REDUCED
configs in float32, one config a family: llama (dense), moonshot (MoE),
deepseek-v2-lite (MLA + MoE), mamba2 (SSM), Jamba (hybrid, an 8-layer
period), phi-3-vision (VLM, patches) and whisper (encoder-decoder).

  * Under ``full`` and ``dots`` the loss and every gradient leaf are
    ``torch.equal`` to ``none``'s: the recompute repeats the forward's
    arithmetic, the MoE routing included.
  * Each ``remat`` against ``jax.value_and_grad`` of the JAX model at the
    same ``remat``, with the tolerances of tests/test_torch_train.py: the
    loss within rtol = 1e-5, every gradient leaf within rtol = 1e-4,
    atol = 1e-4 * (1 + max |leaf|).
  * The checkpoint is real: the bytes of the tensors the forward made that
    are still alive when it returns (what the backward will read) are
    smaller under ``full`` than under ``dots``, and under ``dots`` than
    under ``none``.  ``dots`` keeps its products' outputs in the checkpoint's
    own cache, which ``saved_tensors_hooks`` never sees, so the bytes are
    counted by a dispatch mode that tracks every storage the forward makes.
    Whisper checkpoints ``dots`` as ``full`` (as the JAX package does), so
    its two are equal.
  * A forward autograd does not record (``torch.no_grad()``, or grad mode
    on with no input requiring grad, as prefill runs) never checkpoints:
    ``saved_tensors_hooks`` packs nothing and the logits equal ``none``'s.
"""
import dataclasses
import functools
import gc

import jax
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro.models import zoo as jzoo
from repro_torch.models import transformer, zoo
from repro_torch.tree import tree_leaves, tree_map
from tests.test_torch_train import _batch, _jax, _models, _torch

FAMILIES = ("llama3_2_3b", "moonshot_v1_16b_a3b", "deepseek_v2_lite_16b", "mamba2_780m",
            "jamba_1_5_large_398b", "phi3_vision_4_2b", "whisper_base")
REMATS = ("none", "full", "dots")


def _setup(arch, remat):
    """The JAX model and the port's at ``remat``, the same weights, and a
    batch of 2 x 64 tokens (MoE, SSM, hybrid: two dispatch groups, four
    SSD chunks) or 2 x 16."""
    jmodel, jparams, model, params = _models(arch)
    cfg = dataclasses.replace(model.cfg, remat=remat)
    s = 64 if cfg.family in ("moe", "ssm", "hybrid") else 16
    batch = _batch(cfg, s=s, seed=1)
    jmodel = jzoo.build(dataclasses.replace(jmodel.cfg, remat=remat))
    return jmodel, jparams, zoo.build(cfg, device="cpu"), params, batch


def _leaves(params):
    return tree_map(lambda p: p.detach().clone().requires_grad_(), params)


@functools.cache
def _port(arch, remat):
    """The port's loss and gradient leaves at ``remat``."""
    _, _, model, params, batch = _setup(arch, remat)
    leaves = _leaves(params)
    loss, _ = model.loss_fn(leaves, _torch(batch))
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(leaves)]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_equal_none(arch, remat):
    loss, grads = _port(arch, remat)
    want_loss, want = _port(arch, "none")
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g is not None and torch.equal(g, w), i


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_vs_jax_at_the_same_remat(arch, remat):
    jmodel, jparams, _, _, batch = _setup(arch, remat)
    (want, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, _jax(batch))
    got, grads = _port(arch, remat)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * (1 + np.abs(w).max()))


class _Storages(TorchDispatchMode):
    """Weak references to the storage of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made.append((StorageWeakRef(s), s.nbytes()))
        return out


def _kept_bytes(arch, remat) -> int:
    """Bytes of the storages a recorded forward (the loss) made that are
    alive after it returns, the inputs' own storages left out."""
    _, _, model, params, batch = _setup(arch, remat)
    leaves = _leaves(params)
    batch = _torch(batch)
    inputs = {StorageWeakRef(t.untyped_storage()).cdata
              for t in [*tree_leaves(leaves), *batch.values()]}
    track = _Storages()
    with track:
        loss, _ = model.loss_fn(leaves, batch)
    gc.collect()
    alive = {ref.cdata: n for ref, n in track.made
             if not ref.expired() and ref.cdata not in inputs}
    assert loss.requires_grad
    return sum(alive.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoint_keeps_less(arch):
    kept = {r: _kept_bytes(arch, r) for r in REMATS}
    assert kept["dots"] < kept["none"], kept
    if arch == "whisper_base":
        assert kept["full"] == kept["dots"], kept
    else:
        assert kept["full"] < kept["dots"], kept


@pytest.mark.parametrize("recording", ["no_grad", "grad_mode_no_leaf"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_unrecorded_forward_never_checkpoints(arch, recording, monkeypatch):
    packed = []

    def refuse(*args, **kwargs):
        raise AssertionError("a forward autograd does not record was checkpointed")

    out = {}
    for remat in ("none", "full", "dots"):
        _, _, model, params, batch = _setup(arch, remat)
        batch = {k: v for k, v in _torch(batch).items() if k != "labels"}
        with monkeypatch.context() as m:
            if remat != "none":
                m.setattr(transformer, "checkpoint", refuse)
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: packed.append(t.nbytes) or t, lambda t: t):
                if recording == "no_grad":
                    with torch.no_grad():
                        out[remat] = model.prefill_fn(params, batch)
                else:
                    assert not any(t.requires_grad for t in tree_leaves(params))
                    out[remat] = model.prefill_fn(params, batch)
    assert packed == []
    assert torch.equal(out["full"], out["none"]) and torch.equal(out["dots"], out["none"])
