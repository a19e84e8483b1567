"""Wrappers of the hand-written CUDA MoE pack/unpack (``csrc/moe_onehot.cu``).

Replace ``src/repro/kernels/moe_onehot.py::onehot_dispatch`` and
``::onehot_combine`` (one-hot MXU contractions on the TPU).  Dispatch fills
each packed row once from the tuples that land in it (a head-map memset, a
link kernel and a fill kernel on the current stream), combine gathers one
packed row per tuple; one call covers all dispatch groups of a layer.
Both are bound by bytes; the source says how the design meets that.  The
plain versions are ``ref.onehot_dispatch`` and ``ref.onehot_combine``.
Each kernel is the other's transpose, so they are also each other's
gradient: ``dispatch.OnehotDispatch`` and ``OnehotCombine`` launch them in
their backwards (combine for the pack's dx and for dgate's rows, dispatch
for the unpack's dpacked), and need no backward kernel of their own.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entries():
    lib = _build.load("moe_onehot")
    disp, comb = lib.onehot_dispatch, lib.onehot_combine
    disp.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    comb.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    disp.restype = comb.restype = ctypes.c_int
    return disp, comb


def _check(rows: torch.Tensor, eff: torch.Tensor, slot: torch.Tensor,
           name: str) -> tuple[int, int, int]:
    """Validate the row tensor ``rows`` [G, ..., D] and eff/slot [G, T];
    returns (G, T, D).  Raises on anything the kernels do not take."""
    if rows.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {rows.device}")
    if rows.dtype not in _IS_BF16:
        raise ValueError(f"{name} takes float32|bfloat16 rows, got {rows.dtype}")
    if eff.dim() != 2:
        raise ValueError(f"eff must be [G, T], got {tuple(eff.shape)}")
    g, t = eff.shape
    for label, x in (("eff", eff), ("slot", slot)):
        if x.device != rows.device or x.dtype != torch.int32 or x.shape != (g, t):
            raise ValueError(f"{label} must be [{g}, {t}] int32 on {rows.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    return g, t, rows.shape[-1]


def _stream(t: torch.Tensor) -> int:
    """The raw current stream of ``t``'s device (``torch.cuda.stream``
    contexts included), without building a Stream object (~5 us on an
    H100's host, PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _vec(d: int, *tensors) -> int:
    """1 when every row of the row tensors can move in 16-byte pieces."""
    return int(d * tensors[0].element_size() % 16 == 0
               and all(x.data_ptr() % 16 == 0 for x in tensors))


def onehot_dispatch(eff: torch.Tensor, slot: torch.Tensor, values: torch.Tensor,
                    num_pe: int, capacity: int) -> torch.Tensor:
    """Pack ``values[g, t]`` into ``packed[g, eff[g, t], slot[g, t]]`` on the
    card; dropped tuples are skipped and duplicate cells sum.

    eff, slot: [G, T] int32; values: [G, T, D] float32|bfloat16; all
    contiguous on one CUDA device.  Returns a new [G, num_pe, capacity, D]
    tensor of values' dtype, each row written once.  Raises on any other
    input and if a launch fails."""
    g, t, d = _check(values, eff, slot, "onehot_dispatch")
    if values.shape != (g, t, d):
        raise ValueError(f"values must be [{g}, {t}, D], got {tuple(values.shape)}")
    packed = torch.empty((g, num_pe, capacity, d), dtype=values.dtype,
                         device=values.device)
    if packed.numel() >= 2**31 or g * t >= 2**31:
        raise ValueError("onehot_dispatch takes fewer than 2**31 cells and rows")
    if packed.numel() == 0:
        return packed
    # the head map (one int32 per packed row) and the lists (one per tuple)
    scratch = torch.empty(g * num_pe * capacity + g * t, dtype=torch.int32,
                          device=values.device)
    err = _entries()[0](packed.data_ptr(), scratch.data_ptr(), eff.data_ptr(),
                        slot.data_ptr(), values.data_ptr(), g, t, d, num_pe, capacity,
                        _IS_BF16[values.dtype], _vec(d, packed, values),
                        _stream(values))
    if err:
        raise RuntimeError(f"onehot_dispatch launch failed: CUDA error {err}")
    onehot_dispatch.launches += 1
    return packed


def onehot_combine(eff: torch.Tensor, slot: torch.Tensor, packed: torch.Tensor,
                   gate: torch.Tensor | None = None) -> torch.Tensor:
    """Gather ``y[g, t] = gate[g, t] * packed[g, eff[g, t], slot[g, t]]`` on
    the card, zero rows for dropped tuples.

    packed: [G, num_pe, capacity, D] float32|bfloat16; eff, slot: [G, T]
    int32; gate: [G, T] of packed's dtype, or None for 1; all contiguous on
    one CUDA device.  Returns a new [G, T, D] tensor.  Raises on any other
    input and if the launch fails."""
    g, t, d = _check(packed, eff, slot, "onehot_combine")
    if packed.dim() != 4 or packed.shape[0] != g:
        raise ValueError(f"packed must be [{g}, P, C, D], got {tuple(packed.shape)}")
    if gate is not None and (gate.device != packed.device or gate.dtype != packed.dtype
                             or gate.shape != (g, t) or not gate.is_contiguous()):
        raise ValueError(f"gate must be contiguous [{g}, {t}] {packed.dtype} on "
                         f"{packed.device}, got {tuple(gate.shape)} {gate.dtype} "
                         f"on {gate.device}")
    _, num_pe, capacity, _ = packed.shape
    if packed.numel() >= 2**31 or g * t * d >= 2**31:
        raise ValueError("onehot_combine takes fewer than 2**31 cells and outputs")
    y = torch.empty((g, t, d), dtype=packed.dtype, device=packed.device)
    err = _entries()[1](y.data_ptr(), eff.data_ptr(), slot.data_ptr(),
                        packed.data_ptr(), 0 if gate is None else gate.data_ptr(),
                        g, t, d, num_pe, capacity, _IS_BF16[packed.dtype],
                        _vec(d, y, packed),
                        _stream(packed))
    if err:
        raise RuntimeError(f"onehot_combine launch failed: CUDA error {err}")
    onehot_combine.launches += 1
    return y


onehot_dispatch.launches = 0
onehot_combine.launches = 0
