"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers with launch counters, and their plain PyTorch versions.

  route_accumulate -- PriPE/SecPE buffer update (add|max, int32|float32)
  cms_update       -- count-min sketch multi-row update (HHD)

``dispatch`` is what the executor calls: the tensor's device picks the
plain version (CPU) or the kernel (CUDA).
"""
from repro_torch.kernels import dispatch, ref

__all__ = ["dispatch", "ref"]
