"""Checkpointing of the port (mirrors ``repro/checkpoint``): atomic,
asynchronous save and restore of a training state."""
from .ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
