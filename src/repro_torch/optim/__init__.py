"""Optimizers, clipping and schedules (counterpart of ``repro/optim``)."""
from .clip import clip_by_global_norm, global_norm
from .optimizers import Optimizer, adamw, sgd
from .schedules import constant, cosine_warmup

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "constant",
           "cosine_warmup", "global_norm", "sgd"]
