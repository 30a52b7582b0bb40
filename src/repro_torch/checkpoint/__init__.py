"""Checkpoints (port of ``repro.checkpoint``): ``CheckpointManager``."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
