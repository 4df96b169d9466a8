"""Models (dense GQA transformer LM in this slice)."""
from .common import ModelSpec
from .registry import ModelApi, build_model, param_groups

__all__ = ["ModelApi", "ModelSpec", "build_model", "param_groups"]
