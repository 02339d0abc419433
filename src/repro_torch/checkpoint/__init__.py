"""Checkpointing of the port (mirrors ``repro/checkpoint``): atomic,
asynchronous save and restore of a training state, and its elastic
restore onto another mesh."""
from .ckpt import CheckpointManager
from .elastic import elastic_restore

__all__ = ["CheckpointManager", "elastic_restore"]
