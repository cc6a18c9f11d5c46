"""Optimizers, schedules and gradient compression (the reference's
``optim`` package in PyTorch)."""

from .optimizers import adamw, apply_updates, global_norm, sgd

__all__ = ["adamw", "sgd", "apply_updates", "global_norm"]
