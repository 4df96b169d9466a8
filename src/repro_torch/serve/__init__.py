"""Serving: the KV-cache prefill and decode steps, the batched engine and
the cache's sharding rules (counterpart of ``repro/serve``)."""
from .engine import ServeConfig, ServeEngine
from .sharding import cache_pspecs
from .step import make_decode_step, make_prefill_step

__all__ = ["ServeConfig", "ServeEngine", "cache_pspecs", "make_decode_step",
           "make_prefill_step"]
