"""Wrapper of the hand-written CUDA PE buffer update (``csrc/route_accumulate.cu``).

Replaces ``src/repro/kernels/route_accumulate.py::route_accumulate`` (the
one-hot MXU scatter) and the flatten-and-fold around it in
``repro/kernels/dispatch.pe_buffer_update``: the kernel computes
``eff * local + idx`` itself and folds straight into the carried buffers.
It is bound by bytes (12 B a tuple plus one read and one write of each
cell touched) and, at the executor's chunk sizes, by the host time of its
call, so the path is short: one call into the source's CPython extension
module, which checks the tensors, reads the current stream and launches in
C; the message of a refused input is worked out in Python only then.  The
plain version is ``ref.pe_buffer_update``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

_FLOATS = (torch.int32, torch.float32)
_IS_MAX = {"add": 0, "max": 1}


@functools.cache
def _entry():
    """``update(buffers, eff, idx, value, is_max)`` of the source's CPython
    extension module: checks the four tensors and launches in C; returns 1
    after a launch, 0 when there is nothing to fold and -1 for inputs the
    kernel does not take."""
    return _build.load_module("route_accumulate").update


def _input_error(buffers, eff, idx, value) -> ValueError:
    """What is wrong with inputs that ``update`` refused."""
    if buffers.dim() != 2 or buffers.dtype not in _FLOATS:
        return ValueError(f"buffers must be 2-D int32|float32, got "
                          f"{tuple(buffers.shape)} {buffers.dtype}")
    n = eff.shape[0] if eff.dim() else 0
    for name, t, dtype in (("eff", eff, torch.int32), ("idx", idx, torch.int32),
                           ("value", value, buffers.dtype)):
        if t.device != buffers.device or t.dtype != dtype or t.shape != (n,):
            return ValueError(f"{name} must be [{n}] {dtype} on {buffers.device}, "
                              f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("buffers", buffers), ("eff", eff), ("idx", idx),
                    ("value", value)):
        if not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    return ValueError("route_accumulate takes fewer than 2**31 bins and tuples")


def route_accumulate(buffers: torch.Tensor, eff: torch.Tensor,
                     idx: torch.Tensor, value: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """Fold ``value[t]`` into ``buffers[eff[t], idx[t]]`` IN PLACE on the
    card and return ``buffers``.

    buffers: [num_pe, local] int32|float32, contiguous, on a CUDA device.
    eff, idx: [T] int32; value: [T] of the buffers' dtype; all contiguous on
    the same device.  Out-of-range (eff, idx) entries are dropped.  Raises
    on any other input, and if the launch fails.  Launches on the device's
    current stream (``torch.cuda.stream`` contexts included)."""
    is_max = _IS_MAX.get(combine)
    if is_max is None:
        raise ValueError(f"combine must be add|max, got {combine!r}")
    if not buffers.is_cuda:
        raise ValueError(f"route_accumulate runs on CUDA tensors, got {buffers.device}")
    launched = _entry()(buffers, eff, idx, value, is_max)
    if launched < 0:
        raise _input_error(buffers, eff, idx, value)
    route_accumulate.launches += launched
    return buffers


route_accumulate.launches = 0
