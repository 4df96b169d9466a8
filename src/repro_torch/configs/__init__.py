"""Architecture configs and input shapes (counterpart of
``repro/configs``)."""
from .base import (LONG_CONTEXT_WINDOW, SHAPES, InputShape, input_specs,
                   long500k_policy, shape_supported, spec_for_shape)
from .registry import ARCHS, get_spec, list_archs

__all__ = ["LONG_CONTEXT_WINDOW", "SHAPES", "InputShape", "input_specs",
           "long500k_policy", "shape_supported", "spec_for_shape", "ARCHS",
           "get_spec", "list_archs"]
