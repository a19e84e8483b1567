"""Wrapper of the hand-written CUDA PE buffer update (``csrc/route_accumulate.cu``).

Replaces ``src/repro/kernels/route_accumulate.py::route_accumulate`` (the
one-hot MXU scatter) and the flatten-and-fold around it in
``repro/kernels/dispatch.pe_buffer_update``: the kernel computes
``eff * local + idx`` itself and folds straight into the carried buffers.
It is bound by bytes (12 B a tuple plus one read and one write of each
cell touched) and, at the executor's chunk sizes, by its launch; the source
says how the design meets skew.  The plain version is ``ref.pe_buffer_update``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_IS_FLOAT = {torch.int32: 0, torch.float32: 1}
_IS_MAX = {"add": 0, "max": 1}


@functools.cache
def _entry():
    fn = _build.load("route_accumulate").route_accumulate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route_accumulate(buffers: torch.Tensor, eff: torch.Tensor,
                     idx: torch.Tensor, value: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """Fold ``value[t]`` into ``buffers[eff[t], idx[t]]`` IN PLACE on the
    card and return ``buffers``.

    buffers: [num_pe, local] int32|float32, contiguous, on a CUDA device.
    eff, idx: [T] int32; value: [T] of the buffers' dtype; all contiguous on
    the same device.  Out-of-range (eff, idx) entries are dropped.  Raises
    on any other input, and if the launch fails."""
    if combine not in _IS_MAX:
        raise ValueError(f"combine must be add|max, got {combine!r}")
    if buffers.device.type != "cuda":
        raise ValueError(f"route_accumulate runs on CUDA tensors, got {buffers.device}")
    if buffers.dim() != 2 or buffers.dtype not in _IS_FLOAT:
        raise ValueError(f"buffers must be 2-D int32|float32, got "
                         f"{tuple(buffers.shape)} {buffers.dtype}")
    n = eff.shape[0]
    for name, t, dtype in (("eff", eff, torch.int32), ("idx", idx, torch.int32),
                           ("value", value, buffers.dtype)):
        if t.device != buffers.device or t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name} must be [{n}] {dtype} on {buffers.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("buffers", buffers), ("eff", eff), ("idx", idx),
                    ("value", value)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_pe, local = buffers.shape
    if num_pe * local >= 2**31 or n >= 2**31:
        raise ValueError("route_accumulate takes fewer than 2**31 bins and tuples")
    if n == 0:
        return buffers
    err = _entry()(buffers.data_ptr(), eff.data_ptr(), idx.data_ptr(),
                   value.data_ptr(), n, num_pe, local, _IS_MAX[combine],
                   _IS_FLOAT[buffers.dtype],
                   torch.cuda.current_stream(buffers.device).cuda_stream)
    if err:
        raise RuntimeError(f"route_accumulate launch failed: CUDA error {err}")
    route_accumulate.launches += 1
    return buffers


route_accumulate.launches = 0
