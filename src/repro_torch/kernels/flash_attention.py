"""Wrappers of the hand-written CUDA flash attention forward
(``csrc/flash_attention.cu``) and backward (``csrc/flash_attention_bwd.cu``),
and the autograd function that joins them.

The forward replaces ``src/repro/kernels/flash_attention.py::flash_attention``.
Bound by operations at the prefill shape.  bfloat16 inputs (the model's
prefill) run on the tensor cores (bf16 ``mma.sync``, a ``cp.async`` ring);
float32 inputs keep float32 FMAs on the CUDA cores.  The source says how
each is laid out.  The plain version is ``ref.flash_attention``.

The backward has no Pallas counterpart (the JAX package differentiates
``sdpa_chunked`` with ``jax.grad``); it recomputes the probabilities from
the forward's row log-sum-exp, as FlashAttention-2 does.  bfloat16 runs one
pass over the (key block, query tile) pairs on the tensor cores, a CTA per
(batch, query head, key block), and adds dQ into a float32 accumulator with
atomics, so bf16 dq differs from run to run in its last bits (as PyTorch's
flash backward does); dk and dv are summed in a fixed order.  float32, the
parity path, runs on the CUDA cores without atomics and is deterministic.
Its plain version is ``ref.flash_attention_bwd``.  ``FlashAttention`` is the
``torch.autograd.Function`` that ``dispatch.flash_attention`` applies to
CUDA tensors under grad: its forward keeps the log-sum-exp, its backward
launches the backward kernel.
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_scratch_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(softcap: float, **tensors) -> None:
    """Raise unless the named tensors are what the kernels take: one dtype
    (float32|bfloat16) on one CUDA device, contiguous, q-shaped ones
    [B, Sq, H, dh] and k-shaped ones [B, Sk, KV, dh] with H a multiple of
    KV and dh <= 256, fewer than 2**31 elements each."""
    q, k = tensors["q"], tensors["k"]
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
    if kvh == 0 or h % kvh:
        raise ValueError(f"heads {h} must be a multiple of kv heads {kvh}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes dh <= {MAX_HEAD_DIM}, got {dh}")
    for name, t in tensors.items():
        want = (b, sk, kvh, dh) if name in ("k", "v") else (b, sq, h, dh)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} must have fewer than 2**31 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
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
    float32 runs in float32 throughout.  With ``return_lse`` it returns
    (out, lse): lse [B, H, Sq] float32, each row's log-sum-exp of the scores
    as the softmax takes them (+inf for a row that keeps no key)."""
    _check(softcap, q=q, k=k, v=v)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _entry()(out.data_ptr(), lse.data_ptr() if return_lse else None,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   b, sq, sk, h, kvh, dh, dh ** -0.5, int(causal), int(window),
                   float(softcap), _IS_BF16[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal=,
    window=, softcap=)`` whose output was ``o`` and row log-sum-exp ``lse``
    (``return_lse=True``), given the output's gradient ``do``, on the card.

    q, o, do [B, Sq, H, dh] and k, v [B, Sk, KV, dh] of one dtype
    (float32|bfloat16) on one CUDA device, contiguous; lse float32
    [B, H, Sq].  dk and dv sum over the query heads that share a KV head.
    bfloat16 runs on the tensor cores and rounds P and dS to bf16 before
    their products; its dq is summed by float32 atomics, so its last bits
    vary from run to run.  float32 runs in float32 throughout, without
    atomics.  Raises on any other input and if a launch fails."""
    _check(softcap, q=q, k=k, v=v, o=o, do=do)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 [{b}, {h}, {sq}] on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Delta and, for bf16, dq's float32 accumulator and the GQA partials
    scratch = torch.empty(_bwd_scratch_entry()(b, sq, sk, h, kvh, dh, _IS_BF16[q.dtype]),
                          dtype=torch.float32, device=q.device)
    err = _bwd_entry()(dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                       q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       do.data_ptr(), lse.data_ptr(),
                       b, sq, sk, h, kvh, dh, dh ** -0.5, int(causal), int(window),
                       float(softcap), _IS_BF16[q.dtype],
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward kernel as the gradient:
    ``FlashAttention.apply(q, k, v, causal, window, softcap)``.  The forward
    keeps q, k, v, the output and its log-sum-exp; the backward makes the
    incoming gradient contiguous and launches ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = {"causal": causal, "window": window, "softcap": softcap}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, **ctx.opts)
        return dq, dk, dv, None, None, None
