"""Wrapper of the hand-written CUDA count-min sketch update (``csrc/cms_update.cu``).

Replaces ``src/repro/kernels/cms_update.py::cms_update``, HHD's PE update.
It is bound by bytes (4 + 4*depth + 4 B a tuple plus one read and one write
of each sketch cell touched) and, at the executor's chunk sizes, by the
host time of its call, so the path is short: one call into the source's
CPython extension module, which checks the tensors, reads the current
stream and launches in C; the message of a refused input is worked out in
Python only then.  The plain version is ``ref.cms_update``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.int32, torch.float32)


@functools.cache
def _entry():
    """``update(sketch, eff, cols, value)`` of the source's CPython extension
    module: checks the four tensors and launches in C; returns 1 after a
    launch, 0 for an empty chunk and -1 for inputs the kernel does not
    take."""
    return _build.load_module("cms_update").update


def _input_error(sketch, eff, cols, value) -> ValueError:
    """What is wrong with inputs that ``update`` refused."""
    if sketch.dim() != 3 or sketch.dtype not in _FLOATS:
        return ValueError(f"sketch must be 3-D int32|float32, got "
                          f"{tuple(sketch.shape)} {sketch.dtype}")
    depth = sketch.shape[1]
    n = eff.shape[0] if eff.dim() else 0
    for name, t, dtype, shape in (
            ("eff", eff, torch.int32, (n,)),
            ("cols", cols, torch.int32, (n, depth)),
            ("value", value, sketch.dtype, (n,))):
        if t.device != sketch.device or t.dtype != dtype or t.shape != shape:
            return ValueError(f"{name} must be {list(shape)} {dtype} on "
                              f"{sketch.device}, got {tuple(t.shape)} {t.dtype} "
                              f"on {t.device}")
    for name, t in (("sketch", sketch), ("eff", eff), ("cols", cols),
                    ("value", value)):
        if not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    return ValueError("cms_update takes fewer than 2**31 cells and tuples")


def cms_update(sketch: torch.Tensor, eff: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Add ``value[t]`` to ``sketch[eff[t], d, cols[t, d]]`` for every row d,
    IN PLACE on the card, and return ``sketch``.

    sketch: [num_pe, depth, width] int32|float32, contiguous, on a CUDA
    device.  eff: [T] int32; cols: [T, depth] int32; value: [T] of the
    sketch's dtype; all contiguous on the same device.  Tuples with eff
    outside [0, num_pe) or a column outside [0, width) are dropped.  Raises
    on any other input, and if the launch fails.  Launches on the device's
    current stream (``torch.cuda.stream`` contexts included)."""
    if not sketch.is_cuda:
        raise ValueError(f"cms_update runs on CUDA tensors, got {sketch.device}")
    launched = _entry()(sketch, eff, cols, value)
    if launched < 0:
        raise _input_error(sketch, eff, cols, value)
    cms_update.launches += launched
    return sketch


cms_update.launches = 0
