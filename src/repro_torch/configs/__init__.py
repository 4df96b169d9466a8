"""Architecture configs (counterpart of ``repro/configs``)."""
from .registry import get_spec, list_archs

__all__ = ["get_spec", "list_archs"]
