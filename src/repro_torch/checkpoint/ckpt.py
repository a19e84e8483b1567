"""Async, atomic checkpointing of trees of tensors, in the JAX package's
on-disk layout.

The counterpart of ``repro/checkpoint/ckpt.py``.  One checkpoint:

    <dir>/step_<n>.tmp/...      (write)
    <dir>/step_<n>/             (atomic os.replace once complete)
        manifest.json           num_leaves, treedef, paths, shapes, dtypes
        leaf_<i>.npy            one array per leaf, row-major, on the host

The port flattens its own trees: dict keys sorted, dataclass fields (and
named-tuple fields) in declared order, list and tuple items in order, None
an empty subtree, every other object a leaf.  That is JAX's leaf order for
the same structure, and ``paths`` holds the strings that
``jax.tree_util.keystr`` gives them (``['lanes'].buffers``), so a
checkpoint written by either package restores in the other: a restore reads
only ``num_leaves`` and each leaf's shape and dtype, never ``treedef``,
which describes the writer's own tree types.  A bfloat16 tensor is written
as float32 (numpy has no bfloat16 without ml_dtypes); the template's dtype
casts it back.

  * ATOMIC: a checkpoint becomes visible only through the final rename.
  * ASYNC: ``CheckpointManager.save`` copies the tensors to the host (the
    only synchronous part) and writes them on a background thread.
  * KEEP-K: the manager keeps the newest ``keep`` steps; ``.tmp`` dirs and
    dirs without a manifest are ignored; a corrupt step is skipped by
    ``restore`` in favour of the previous one.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) pairs of an inner node in JAX's order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's leaf order; None holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for key, child in kids for pair in _flatten(child, prefix + key)]


def _treedef(tree) -> str:
    """A description of the tree's structure (the manifest's ``treedef``;
    informative only)."""
    if tree is None:
        return "None"
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k}: {_treedef(c)}" for k, c in kids)
    return f"{type(tree).__name__}({inner})"


def _unflatten(template, leaves: List[Any]):
    """``template`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{f.name: build(getattr(node, f.name))
                                                for f in dataclasses.fields(node)})
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, n)) for n in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(template)


def _to_host(leaf) -> np.ndarray:
    """A host copy of a tensor leaf (a CPU tensor's numpy view is copied,
    so later in-place updates cannot reach an async write)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy().copy() if leaf.device.type == "cpu" else leaf.cpu().numpy()
    return np.asarray(leaf)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _fsync_dir(path: Path):
    """Flush directory metadata so a rename survives a machine crash
    (best-effort on filesystems without directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_pytree(path: os.PathLike, tree: Any):
    """Blocking crash-safe save of one tree: every leaf and the manifest are
    written (and fsync'd) into a temp dir, which becomes visible only
    through the final atomic rename -- a writer killed at any instruction
    leaves the previous checkpoint or a ``.tmp`` dir that inventory and
    restore ignore, never a half-checkpoint under the real name."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten(tree)
    manifest = {"num_leaves": len(flat), "treedef": _treedef(tree),
                "paths": [p for p, _ in flat], "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr = _to_host(leaf)
        with open(tmp / f"leaf_{i}.npy", "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(tmp / "manifest.json", "w") as f:
        f.write(json.dumps(manifest))
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def restore_pytree(path: os.PathLike, template: Any, device="cuda") -> Any:
    """Restore into the structure of ``template``: each leaf becomes a
    tensor on ``device``, cast to the template leaf's dtype when it has one
    (a tensor, a numpy array, or any object with ``dtype``)."""
    path = Path(path)
    device = resolve_device(device)
    manifest = json.loads((path / "manifest.json").read_text())
    flat_t = [leaf for _, leaf in _flatten(template)]
    if manifest["num_leaves"] != len(flat_t):
        raise ValueError(f"checkpoint at {path} has {manifest['num_leaves']} leaves, "
                         f"template has {len(flat_t)}")
    leaves = []
    for i, t in enumerate(flat_t):
        arr = np.load(path / f"leaf_{i}.npy")
        want = manifest["leaves"][i]
        if list(arr.shape) != want["shape"]:
            raise ValueError(f"leaf {i} shape mismatch: {arr.shape} vs "
                             f"manifest {want['shape']}")
        x = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        if hasattr(t, "dtype"):
            x = x.to(_torch_dtype(t.dtype))
        leaves.append(x.to(device))
    return _unflatten(template, leaves)


class CheckpointManager:
    """Keep-k async checkpoint manager over a directory."""

    def __init__(self, directory: os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: Optional[cf.Future] = None

    # ------------------------------------------------------------- inventory
    def steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp") or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step}"

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, block: bool = False):
        """Copy to the host now; write in the background."""
        self.wait()          # one in flight at a time (bounds host memory)
        host = _unflatten(tree, [_to_host(leaf) for _, leaf in _flatten(tree)])
        self._pending = self._pool.submit(self._save_and_gc, step, host)
        if block:
            self.wait()

    def _save_and_gc(self, step: int, host_tree: Any):
        save_pytree(self._path(step), host_tree)
        for s in self.steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # --------------------------------------------------------------- restore
    def restore(self, template: Any, step: Optional[int] = None,
                device="cuda") -> Optional[Any]:
        """Restore the newest checkpoint that loads.

        With ``step=None`` the steps are tried newest first, and one whose
        files are truncated or corrupt is skipped with a warning.  If
        checkpoints exist and every one fails, this raises rather than
        returning None, so a resuming caller cannot silently restart from
        scratch.  An explicit ``step`` raises on corruption.  Returns None
        only when there is no checkpoint at all."""
        if step is not None:
            return restore_pytree(self._path(step), template, device)
        errors = []
        for s in reversed(self.steps()):
            try:
                return restore_pytree(self._path(s), template, device)
            except Exception as e:  # noqa: BLE001 -- any unreadable checkpoint
                warnings.warn(f"skipping unreadable checkpoint {self._path(s)}: {e!r}")
                errors.append(e)
        if errors:
            raise RuntimeError(
                f"all {len(errors)} checkpoints under {self.dir} failed "
                f"to load (newest error: {errors[0]!r}); repair/remove "
                "them or fix the restore template")
        return None

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
