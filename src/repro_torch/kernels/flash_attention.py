"""Wrapper of the hand-written CUDA flash attention forward
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``.  Bound
by operations at the prefill shape.  bfloat16 inputs (the model's prefill)
run on the tensor cores (bf16 ``mma.sync``, a ``cp.async`` ring); float32
inputs keep float32 FMAs on the CUDA cores.  The source says how each is
laid out.  The plain version is ``ref.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Online-softmax attention on the card: q [B, Sq, H, dh], k/v
    [B, Sk, KV, dh] -> [B, Sq, H, dh] in q's dtype, scale dh^-0.5.

    Query and key positions are their indices; ``window`` > 0 keeps keys
    j > i - window; head j reads KV head j // (H / KV).  A ``softcap`` > 0
    maps each kept scaled score s to softcap * tanh(s / softcap) (tanhf)
    before the softmax, as the JAX model does (the Pallas kernel has no
    cap); the cap is a runtime argument.  All three tensors float32|bfloat16
    of one dtype, contiguous, on one CUDA device; dh <= 256.  Raises on any
    other input, a negative cap, and if the launch fails.  bfloat16 runs on
    the tensor cores and rounds the probabilities to bf16 before P @ V;
    float32 runs in float32 throughout."""
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got {q.device}")
    if q.dtype not in _IS_BF16:
        raise ValueError(f"flash_attention takes float32|bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, Sk, KV, {dh}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"heads {h} must be a multiple of kv heads {kvh}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes dh <= {MAX_HEAD_DIM}, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} must have fewer than 2**31 elements")
    out = torch.empty_like(q)
    err = _entry()(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   b, sq, sk, h, kvh, dh, dh ** -0.5, int(causal), int(window),
                   float(softcap), _IS_BF16[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
