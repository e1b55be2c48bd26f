"""Checkpoints of the port (a copy of ``repro/checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
