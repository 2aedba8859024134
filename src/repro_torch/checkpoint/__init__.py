"""Atomic, async, self-pruning checkpoints in the reference's on-disk format."""

from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
