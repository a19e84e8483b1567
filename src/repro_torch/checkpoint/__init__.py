"""Checkpointing of the port, in the JAX package's on-disk layout."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, restore_pytree,
                                         save_pytree)

__all__ = ["CheckpointManager", "restore_pytree", "save_pytree"]
