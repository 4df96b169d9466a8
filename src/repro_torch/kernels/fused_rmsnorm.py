"""Fused RMSNorm (K6) on Hopper.

Counterpart of ``repro/kernels/fused_rmsnorm.py``: the kernel of
``csrc/fused_rmsnorm.cu`` replaces the Pallas ``_rmsnorm_kernel``,
``y = x·rsqrt(mean(x²)+eps)·(1+scale)`` with f32 statistics per row.
Device-memory bytes bound it: ``rows·d`` values in and out, plus the
scale and the per-row ``rstd``.  The kernel reads each row once: a thread
keeps its share of the row in registers as 16-byte vectors, the row's
sum of squares is reduced across a warp (rows of up to 1024 values) or a
128- or 256-thread block (wider rows), and ``y`` is written from the same
registers.  It takes that vector path when ``x``, ``y`` and ``scale``
start on 16-byte boundaries (:func:`backend.vector_aligned`), ``d`` is a
multiple of the vector width (8 bf16 or 4 f32 values) and the row fits
the kernel's registers (at most ``16384`` bf16 or ``8192`` f32 values);
other rows take the scalar loop of the same kernel, which
``fused_rmsnorm.scalar_launches`` counts.

:func:`fused_rmsnorm` takes :func:`rmsnorm_plain` for CPU tensors and
launches the kernel for CUDA tensors, or raises.  Both return
``(y, rstd)``.  :class:`RMSNormFn` is the model's norm: its forward is
:func:`fused_rmsnorm`, it saves ``x`` and the f32 ``rstd`` (not an f32
copy of ``x``), and its backward is the closed-form gradient in plain
torch, f32 — the reference has no backward kernel for K6 either.

The wrapper counts its launches in ``fused_rmsnorm.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import backend

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``(y, rstd)``: the reference's ``models.common.rmsnorm`` term for
    term, and ``rstd`` of shape ``x.shape[:-1]`` in f32."""
    xf = x.to(torch.float32)
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = (xf * rstd) * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype), rstd[..., 0]


def _lib():
    lib = backend.load("fused_rmsnorm")
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p]
        lib.rmsnorm_fwd.restype = ctypes.c_int
        lib.rmsnorm_max_vecs.argtypes = []
        lib.rmsnorm_max_vecs.restype = ctypes.c_int
        lib._typed = True
    return lib


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``(y, rstd)`` for ``x (..., d)`` and ``scale (d,)``."""
    devs = {x.device.type, scale.device.type}
    if devs in ({"cpu"}, {"meta"}):      # meta: the dry run's counting
        return rmsnorm_plain(x, scale, eps)
    if devs != {"cuda"}:
        raise ValueError(f"fused_rmsnorm: unsupported/mixed devices {devs}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rmsnorm kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise TypeError(f"fused_rmsnorm kernel takes a float32 scale of "
                        f"shape ({d},), got {scale.dtype} "
                        f"{tuple(scale.shape)}")
    backend.check_cuda("fused_rmsnorm", x, scale)
    rows = x.numel() // d if d else 0
    if rows == 0:
        raise ValueError("fused_rmsnorm of an empty tensor")
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    lib = _lib()
    width = 16 // x.element_size()
    vec = (backend.vector_aligned(x, y, scale) and d % width == 0
           and d // width <= lib.rmsnorm_max_vecs())
    backend.check(lib.rmsnorm_fwd(
        _DTYPE_CODE[x.dtype], backend.ptr(x), backend.ptr(scale),
        backend.ptr(y), backend.ptr(rstd), rows, d, float(eps), int(vec),
        backend.stream_ptr()), "fused_rmsnorm")
    fused_rmsnorm.launches += 1
    fused_rmsnorm.scalar_launches += not vec
    return y, rstd


fused_rmsnorm.launches = 0
fused_rmsnorm.scalar_launches = 0


def rmsnorm_grad(x, scale, rstd, gy):
    """``(dx, dscale)`` of ``y = x·r·(1+scale)``, ``r = rsqrt(mean(x²)+eps)``,
    in f32: ``dx = r·(g·w − x̂·mean(g·w·x̂))`` with ``x̂ = x·r``,
    ``w = 1+scale``; ``dscale = Σ_rows g·x̂``."""
    d = x.shape[-1]
    xhat = x.to(torch.float32) * rstd[..., None]
    g = gy.to(torch.float32)
    gw = g * (1.0 + scale.to(torch.float32))
    dx = rstd[..., None] * (gw - xhat * torch.mean(gw * xhat, dim=-1,
                                                   keepdim=True))
    dscale = (g * xhat).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm(x, scale)`` through K6 (CUDA) or its plain version (CPU),
    with the closed-form backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = fused_rmsnorm(x.contiguous(), scale.contiguous(), eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_grad(x, scale, rstd, gy)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)
