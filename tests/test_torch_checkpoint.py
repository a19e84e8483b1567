"""The port's checkpoint subsystem (``repro_torch.checkpoint``): the cases
of ``tests/test_checkpoint.py`` (atomicity, keep-k, async, corrupt steps
skipped, dtype casts, shape checks) on trees of tensors, and the on-disk
layout shared with the JAX package: the same leaf order and ``paths``
strings, and a checkpoint saved by either package restores in the other.
The manifests' ``treedef`` strings differ (each names its own tree
types); the JAX restore reads only ``num_leaves`` and each leaf's shape and
dtype, which the cross-package tests show."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dp as jdp
from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.checkpoint.ckpt import restore_pytree as jrestore_pytree
from repro.checkpoint.ckpt import save_pytree as jsave_pytree
from repro.core import executor as jexecutor
from repro_torch.apps import dp
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.core import executor


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.tensor(2.5, dtype=torch.float32)}}


def _leaves_equal(a, b):
    from repro_torch.checkpoint.ckpt import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert torch.equal(torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y)))


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(tmp_path / "ck", t)
    got = restore_pytree(tmp_path / "ck", t, device="cpu")
    _leaves_equal(got, t)
    assert got["nested"]["b"].dtype == torch.int32


def test_atomic_no_tmp_left(tmp_path):
    save_pytree(tmp_path / "ck", _tree())
    assert not (tmp_path / "ck.tmp").exists()
    assert (tmp_path / "ck" / "manifest.json").exists()


def test_leaf_count_mismatch_raises(tmp_path):
    save_pytree(tmp_path / "ck", _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree(tmp_path / "ck", {"only": torch.zeros(3)}, device="cpu")


def test_manager_keep_k_and_latest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.full((2,), float(s))}, block=True)
    assert m.steps() == [3, 4]
    assert m.latest_step() == 4
    got = m.restore({"x": torch.zeros(2)}, device="cpu")
    assert got["x"].tolist() == [4.0, 4.0]
    m.close()


def test_manager_restore_none_when_empty(tmp_path):
    m = CheckpointManager(tmp_path)
    assert m.latest_step() is None
    assert m.restore({"x": torch.zeros(2)}, device="cpu") is None
    m.close()


def test_async_save_then_wait(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    t = _tree()
    m.save(7, t)                 # async: the host copy is taken now
    t["a"].add_(1.0)             # so a later in-place write does not leak in
    m.wait()
    assert m.steps() == [7]
    _leaves_equal(m.restore(_tree(), device="cpu"), _tree())
    m.close()


def test_half_written_checkpoint_is_invisible(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, _tree(), block=True)
    crash = tmp_path / "step_2.tmp"
    crash.mkdir()
    (crash / "leaf_0.npy").write_bytes(b"garbage")
    (tmp_path / "step_3").mkdir()             # a dir without manifest
    assert m.steps() == [1]
    assert m.latest_step() == 1
    m.close()


def test_restore_skips_truncated_checkpoint(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, {"x": torch.arange(4, dtype=torch.int32)}, block=True)
    m.save(2, {"x": torch.arange(4, dtype=torch.int32) * 10}, block=True)
    leaf = tmp_path / "step_2" / "leaf_0.npy"
    leaf.write_bytes(leaf.read_bytes()[:8])
    with pytest.warns(UserWarning, match="skipping unreadable"):
        got = m.restore({"x": torch.zeros(4, dtype=torch.int32)}, device="cpu")
    assert got["x"].tolist() == [0, 1, 2, 3]
    m.close()


def test_restore_all_corrupt_raises_loudly(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, {"x": torch.arange(3)}, block=True)
    (tmp_path / "step_1" / "leaf_0.npy").write_bytes(b"not an npy")
    with pytest.warns(UserWarning, match="skipping unreadable"):
        with pytest.raises(RuntimeError, match="failed to load"):
            m.restore({"x": torch.zeros(3)}, device="cpu")
    m.close()


def test_restore_explicit_corrupt_step_still_raises(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, {"x": torch.arange(3)}, block=True)
    m.save(2, {"x": torch.arange(3)}, block=True)
    (tmp_path / "step_2" / "manifest.json").write_text("{ truncated")
    with pytest.raises(Exception):
        m.restore({"x": torch.zeros(3)}, step=2, device="cpu")
    m.close()


def test_restore_dtype_cast(tmp_path):
    """Restore casts to the template's dtype (a bfloat16 tensor is stored
    as float32 and comes back as bfloat16)."""
    save_pytree(tmp_path / "ck", {"w": torch.ones(4, dtype=torch.float32)})
    got = restore_pytree(tmp_path / "ck", {"w": torch.zeros(4, dtype=torch.bfloat16)},
                         device="cpu")
    assert got["w"].dtype == torch.bfloat16
    save_pytree(tmp_path / "bf", {"w": torch.full((3,), 1.5, dtype=torch.bfloat16)})
    manifest = json.loads((tmp_path / "bf" / "manifest.json").read_text())
    assert manifest["leaves"][0]["dtype"] == "float32"
    got = restore_pytree(tmp_path / "bf", {"w": np.zeros(3, np.float32)}, device="cpu")
    assert got["w"].tolist() == [1.5, 1.5, 1.5]


def test_shape_mismatch_raises(tmp_path):
    save_pytree(tmp_path / "ck", {"w": torch.ones(4)})
    np.save(tmp_path / "ck" / "leaf_0.npy", np.ones((5,), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(tmp_path / "ck", {"w": torch.zeros(4)}, device="cpu")


def test_restore_defaults_to_cuda(tmp_path):
    save_pytree(tmp_path / "ck", {"w": torch.ones(4)})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_pytree(tmp_path / "ck", {"w": torch.zeros(4)})


# ---------------------------------------------------------- across packages

def _lane_trees(lanes=3):
    """The durable engine's checkpoint tree in both packages: every lane of
    a lanes-stacked DP ExecState (dataclass buffers) after two chunks, and
    a uint8 metadata blob."""
    rng = np.random.default_rng(0)
    tuples = rng.integers(0, 1 << 12, (lanes, 2, 64, 2)).astype(np.int32)
    res = executor.make_resumable_executor(dp.make_spec(3, 4, 64), 4, 2, 64, device="cpu")
    st, _ = res.scan_lanes(executor.stack_states(res.init_state(), lanes), tuples)
    jres = jexecutor.make_resumable_executor(jdp.make_spec(3, 4, 64), 4, 2, 64)
    jst, _ = jres.scan_lanes(jexecutor.stack_states(jres.init_state(), lanes),
                             jnp.asarray(tuples))
    blob = np.frombuffer(b'{"step": 1}', dtype=np.uint8)
    return {"lanes": st, "meta": blob}, {"lanes": jst, "meta": blob}


def test_layout_paths_and_leaves_equal_jax(tmp_path):
    tree, jtree = _lane_trees()
    save_pytree(tmp_path / "port", tree)
    jsave_pytree(tmp_path / "jax", jtree)
    mp = json.loads((tmp_path / "port" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert mp["paths"] == mj["paths"]
    assert mp["paths"][0] == "['lanes'].buffers.out" and mp["paths"][-1] == "['meta']"
    assert mp["num_leaves"] == mj["num_leaves"] and mp["leaves"] == mj["leaves"]
    assert mp["treedef"] != mj["treedef"]
    for i in range(mp["num_leaves"]):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"leaf_{i}.npy"),
                                      np.load(tmp_path / "jax" / f"leaf_{i}.npy"))


def test_checkpoints_restore_across_packages(tmp_path):
    """A checkpoint the JAX package saved restores in the port, and one the
    port saved restores in the JAX package, leaf for leaf."""
    tree, jtree = _lane_trees()
    jm = JCheckpointManager(tmp_path / "jax", keep=2)
    jm.save(3, jtree, block=True)
    jm.close()
    got = CheckpointManager(tmp_path / "jax").restore(tree, device="cpu")
    assert isinstance(got["lanes"].buffers, dp.DPBuffers)
    _leaves_equal(got, tree)
    m = CheckpointManager(tmp_path / "port", keep=2)
    m.save(5, tree, block=True)
    m.close()
    jgot = JCheckpointManager(tmp_path / "port").restore(jtree)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(jgot["lanes"].buffers).__name__ == "DPBuffers"
    # the JAX package's own tree test (dict of arrays and a scalar) too
    jsave_pytree(tmp_path / "plain", {"a": jnp.ones((4, 3)),
                                      "nested": {"b": jnp.arange(7, dtype=jnp.int32),
                                                 "c": jnp.float32(2.5)}})
    got = restore_pytree(tmp_path / "plain", _tree(), device="cpu")
    assert got["nested"]["c"].item() == 2.5 and got["nested"]["b"].tolist() == list(range(7))


def test_flatten_order_of_other_containers():
    """Lists, tuples, named tuples and None flatten as JAX flattens them."""
    from collections import namedtuple

    from repro_torch.checkpoint.ckpt import _flatten
    Pair = namedtuple("Pair", "x y")
    tree = {"z": [np.zeros(1), (np.ones(2), None)], "a": Pair(np.zeros(3), np.zeros(4)),
            "n": None}
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert [p for p, _ in _flatten(tree)] == [jax.tree_util.keystr(k) for k, _ in jflat]
    assert dataclasses.is_dataclass(dp.DPBuffers)
