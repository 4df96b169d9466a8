"""Hand-written Hopper kernels and their plain torch versions."""
from .backend import resolve_device
from .fused_adamw import adamw_update
from .fused_hop import HOP_CODECS, hop_absmax, hop_decode_add, hop_encode

__all__ = ["HOP_CODECS", "adamw_update", "hop_absmax", "hop_decode_add",
           "hop_encode", "resolve_device"]
