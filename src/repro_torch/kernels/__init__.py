"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
wrappers with launch counters (ctypes, or the source's own CPython
extension module where the host's cost of a call matters), and their plain
PyTorch versions.

  route_accumulate -- PriPE/SecPE buffer update (add|max, int32|float32)
  cms_update       -- count-min sketch multi-row update (HHD)
  onehot_dispatch  -- MoE capacity-slot pack (each packed row written once)
  onehot_combine   -- MoE capacity-slot unpack (row gather, gate-scaled)
  flash_attention  -- online-softmax attention forward (causal, window, GQA)

``dispatch`` is what the executor and the models call: the tensor's device picks the
plain version (CPU) or the kernel (CUDA).  ``ops`` is the functional public
API over it, ``ref`` the plain versions.
"""
from repro_torch.kernels import dispatch, ops, ref

__all__ = ["dispatch", "ops", "ref"]
