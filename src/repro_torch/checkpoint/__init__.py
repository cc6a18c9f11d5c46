"""Checkpoints of training states (the reference's ``checkpoint`` package in
PyTorch, in its on-disk layout)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
