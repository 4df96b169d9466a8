"""Synthetic data (counterpart of ``repro/data``)."""
from .synthetic import SyntheticImages, SyntheticText

__all__ = ["SyntheticImages", "SyntheticText"]
