"""Wrapper of the hand-written CUDA count-min sketch update (``csrc/cms_update.cu``).

Replaces ``src/repro/kernels/cms_update.py::cms_update``, HHD's PE update.
It is bound by bytes (4 + 4*depth + 4 B a tuple plus one read and one write
of each sketch cell touched) and, at the executor's chunk sizes, by its launch.  The plain
version is ``ref.cms_update``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_IS_FLOAT = {torch.int32: 0, torch.float32: 1}


@functools.cache
def _entry():
    fn = _build.load("cms_update").cms_update
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cms_update(sketch: torch.Tensor, eff: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Add ``value[t]`` to ``sketch[eff[t], d, cols[t, d]]`` for every row d,
    IN PLACE on the card, and return ``sketch``.

    sketch: [num_pe, depth, width] int32|float32, contiguous, on a CUDA
    device.  eff: [T] int32; cols: [T, depth] int32; value: [T] of the
    sketch's dtype; all contiguous on the same device.  Tuples with eff
    outside [0, num_pe) or a column outside [0, width) are dropped.  Raises
    on any other input, and if the launch fails."""
    if sketch.device.type != "cuda":
        raise ValueError(f"cms_update runs on CUDA tensors, got {sketch.device}")
    if sketch.dim() != 3 or sketch.dtype not in _IS_FLOAT:
        raise ValueError(f"sketch must be 3-D int32|float32, got "
                         f"{tuple(sketch.shape)} {sketch.dtype}")
    num_pe, depth, width = sketch.shape
    n = eff.shape[0]
    for name, t, dtype, shape in (
            ("eff", eff, torch.int32, (n,)),
            ("cols", cols, torch.int32, (n, depth)),
            ("value", value, sketch.dtype, (n,))):
        if t.device != sketch.device or t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {list(shape)} {dtype} on "
                             f"{sketch.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    for name, t in (("sketch", sketch), ("eff", eff), ("cols", cols),
                    ("value", value)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sketch.numel() >= 2**31 or n >= 2**31:
        raise ValueError("cms_update takes fewer than 2**31 cells and tuples")
    if n == 0:
        return sketch
    err = _entry()(sketch.data_ptr(), eff.data_ptr(), cols.data_ptr(),
                   value.data_ptr(), n, num_pe, depth, width,
                   _IS_FLOAT[sketch.dtype],
                   torch.cuda.current_stream(sketch.device).cuda_stream)
    if err:
        raise RuntimeError(f"cms_update launch failed: CUDA error {err}")
    cms_update.launches += 1
    return sketch


cms_update.launches = 0
