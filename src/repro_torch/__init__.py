"""Ditto (skew-oblivious data routing) in PyTorch, for NVIDIA Hopper.

The port of the JAX package ``repro``: the same module names, PyTorch
idiom (plain functions on tensors, frozen dataclasses of tensors, an
explicit ``device``), and hand-written CUDA kernels in place of the Pallas
ones.  Every entry point takes ``device=`` and defaults to ``"cuda"``.
"""
