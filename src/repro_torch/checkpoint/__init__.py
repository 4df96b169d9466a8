"""Checkpoints (counterpart of ``repro/checkpoint``)."""
from .ckpt import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
