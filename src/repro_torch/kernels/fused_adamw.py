"""One-pass AdamW update (K5) on Hopper.

Counterpart of ``repro/kernels/fused_adamw.py``: the kernel of
``csrc/fused_adamw.cu`` replaces the Pallas ``_adamw_kernel``.  It
streams ``(p, g, m, v)`` once and writes ``(p', m', v')``: 16n bytes
read and 12n written in float32, so device-memory bandwidth bounds it.
It moves 16-byte vectors when every pointer is 16-byte aligned
(:func:`backend.vector_aligned`) and takes its scalar loop otherwise;
``adamw_update.scalar_launches`` counts the launches that did.  The
unfused torch chain makes about nine passes over parameter-sized
tensors.

The wrapper takes :func:`adamw_update_plain` for CPU tensors and launches
the kernel for CUDA tensors, or raises.  ``inplace=True`` writes the
results into ``p``, ``m`` and ``v`` (each element is read and written by
one thread, so aliasing is safe) — the optimizer's path, which saves
three parameter-sized allocations per leaf.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from . import backend


def adamw_scalars(*, lr, b1, b2, eps, weight_decay, count) -> dict:
    """The update's scalars rounded to float32 the way the reference
    computes them (``kernels/ref.py:adamw_update_ref``): ``1 - b1`` in
    double rounded once (a weakly typed jnp scalar), the bias
    corrections ``1 - b**count`` in float32."""
    f32 = np.float32
    c = f32(count)
    return {"lr": float(f32(lr)), "b1": float(f32(b1)),
            "one_minus_b1": float(f32(1.0 - b1)), "b2": float(f32(b2)),
            "one_minus_b2": float(f32(1.0 - b2)), "eps": float(f32(eps)),
            "wd": float(f32(weight_decay)),
            "bc1": float(f32(1.0) - f32(b1) ** c),
            "bc2": float(f32(1.0) - f32(b2) ** c)}


def adamw_update_plain(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1, count=1):
    """Plain torch version of the kernel (same operation order)."""
    # 0-d tensors on the data's device, not Python numbers: torch divides
    # by a host scalar as a multiply by its reciprocal on CUDA, which
    # rounds differently from the kernel's (and the reference's) quotient.
    s = {k: torch.tensor(val, dtype=torch.float32, device=p.device)
         for k, val in adamw_scalars(lr=lr, b1=b1, b2=b2, eps=eps,
                                     weight_decay=weight_decay,
                                     count=count).items()}
    guard = backend.flush_denormal() if p.device.type == "cpu" \
        else contextlib.nullcontext()
    with guard:
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        m_new = s["b1"] * m.to(torch.float32) + s["one_minus_b1"] * g32
        v_new = s["b2"] * v.to(torch.float32) \
            + (s["one_minus_b2"] * g32) * g32
        # The square root in float64, rounded once: the correctly rounded
        # float32 root (53 >= 2*24 + 2 bits), as the kernel's and XLA's
        # are; torch's vectorised CPU sqrt is 1 ulp off on some inputs,
        # which the cancellation in p - lr*upd then magnifies.
        root = torch.sqrt((v_new / s["bc2"]).double()).float()
        upd = (m_new / s["bc1"]) / (root + s["eps"]) + s["wd"] * p32
        return ((p32 - s["lr"] * upd).to(p.dtype), m_new.to(m.dtype),
                v_new.to(v.dtype))


def _lib():
    lib = backend.load("fused_adamw")
    if not getattr(lib, "_typed", False):
        lib.adamw_update_f32.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_longlong] + [ctypes.c_float] * 9 \
            + [ctypes.c_int, ctypes.c_void_p]
        lib.adamw_update_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def adamw_update(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, count=1, inplace: bool = False):
    """One AdamW step over a same-shaped ``(p, g, m, v)`` quartet.
    Returns ``(p_new, m_new, v_new)`` — ``(p, m, v)`` themselves when
    ``inplace``."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              count=count)
    tensors = (p, g, m, v)
    if any(t.shape != p.shape for t in tensors):
        raise ValueError("adamw_update: p, g, m, v must share one shape")
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        out = adamw_update_plain(p, g, m, v, **kw)
        if not inplace:
            return out
        with torch.no_grad():
            for dst, src in zip((p, m, v), out):
                dst.copy_(src)
        return p, m, v
    if devs != {"cuda"}:
        raise ValueError(f"adamw_update: unsupported/mixed devices {devs}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("adamw_update kernel takes float32 p, g, m, v")
    backend.check_cuda("adamw_update", *tensors)
    if inplace:
        outs = (p, m, v)
    else:
        outs = tuple(torch.empty_like(t) for t in (p, m, v))
    s = adamw_scalars(**kw)
    vec = backend.vector_aligned(*tensors, *outs)
    backend.check(_lib().adamw_update_f32(
        *(backend.ptr(t) for t in tensors), *(backend.ptr(t) for t in outs),
        p.numel(), s["lr"], s["b1"], s["one_minus_b1"], s["b2"],
        s["one_minus_b2"], s["eps"], s["wd"], s["bc1"], s["bc2"], int(vec),
        backend.stream_ptr()), "adamw_update")
    adamw_update.launches += 1
    adamw_update.scalar_launches += not vec
    return outs


adamw_update.launches = 0
adamw_update.scalar_launches = 0
