"""Fused chunk reduction (K4) on Hopper: the paper's C2 on-device reduction.

Counterpart of ``repro/kernels/fused_reduce.py``: the kernel of
``csrc/fused_reduce.cu`` replaces the Pallas ``_reduce_kernel``.  It sums
k stacked chunks, ``(k, n) -> (n,)``, in float32 whatever the input type
(float32 or bfloat16), so a bf16 sum over many ranks loses no mantissa
bits to sequential rounding, and casts to ``out_dtype`` (float32 or
bfloat16, default the input's).  It is the terminal sum of the
parameter-server pattern, ``core/reducers.py::ps_gather`` with fused hops.

It reads ``k·n`` elements and writes ``n`` against ``k-1`` adds per column,
so device-memory bandwidth bounds it.  Rows are added in order 0..k-1 to
a +0 start, exactly as :func:`fused_reduce_plain` does, so the two agree
bit for bit (and with XLA's reduce for the k <= 16 that the tests check).

The wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; ``fused_reduce.launches`` counts the
launches.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import backend

_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_reduce_plain(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain torch version of the kernel: rows added in order in f32 to
    a +0 start, as XLA's reduce adds to its init value (so a column of
    -0 or subnormals sums to +0, as in the reference)."""
    out_dtype = out_dtype or x.dtype
    guard = backend.flush_denormal() if x.device.type == "cpu" \
        else contextlib.nullcontext()
    with guard:
        acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
        for i in range(x.shape[0]):
            acc = acc + x[i].to(torch.float32)
        return acc.to(out_dtype)


def _lib():
    lib = backend.load("fused_reduce")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_reduce.argtypes = [i, i, vp, i, ctypes.c_longlong, vp, i,
                                     vp]
        lib.fused_reduce.restype = i
        lib._typed = True
    return lib


def fused_reduce(x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Sum k stacked chunks: ``(k, n) -> (n,)`` with f32 accumulation."""
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"fused_reduce takes (k >= 1, n), got "
                         f"{tuple(x.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return fused_reduce_plain(x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_reduce: unsupported device {x.device}")
    if x.dtype not in _CODE or out_dtype not in _CODE:
        raise TypeError(f"fused_reduce kernel takes float32/bfloat16 in and "
                        f"out, got {x.dtype} -> {out_dtype}")
    backend.check_cuda("fused_reduce", x)
    k, n = x.shape
    out = torch.empty((n,), dtype=out_dtype, device=x.device)
    vec = n % (16 // x.element_size()) == 0 and backend.vector_aligned(x)
    backend.check(_lib().fused_reduce(
        _CODE[x.dtype], _CODE[out_dtype], backend.ptr(x), k, n,
        backend.ptr(out), int(vec), backend.stream_ptr()), "fused_reduce")
    fused_reduce.launches += 1
    return out


fused_reduce.launches = 0
