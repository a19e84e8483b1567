"""Optimizers, schedules and gradient compression over the port's trees of
tensors (the counterparts of ``repro/optim``, their state specs
included)."""
from repro_torch.optim.adamw import (AdamW8bitState, AdamWState, Optimizer, adamw,
                                     adamw8bit, apply_updates, clip_by_global_norm,
                                     make_optimizer)
from repro_torch.optim.compression import (CompressionState, compress_decompress,
                                           init_compression)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "AdamWState", "AdamW8bitState", "Optimizer", "adamw", "adamw8bit",
    "make_optimizer", "apply_updates", "clip_by_global_norm", "warmup_cosine",
    "constant", "CompressionState", "init_compression", "compress_decompress",
]
