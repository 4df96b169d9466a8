"""Synthetic data (counterpart of ``repro/data``)."""
from .synthetic import SyntheticImages, SyntheticText, extra_inputs

__all__ = ["SyntheticImages", "SyntheticText", "extra_inputs"]
