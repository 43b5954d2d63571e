"""Checkpoints: atomic manifests, async writes, the reference's on-disk
layout (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
