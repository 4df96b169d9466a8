"""PyTorch/CUDA port of the ``repro`` package, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names and never imports ``jax`` or ``repro``.  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
