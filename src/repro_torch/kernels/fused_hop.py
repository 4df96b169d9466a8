"""Fused codec'd reduction hop: the paper's GDR-Opt kernel, on Hopper.

Counterpart of ``repro/kernels/fused_hop.py``.  One kernel pass per side
of a coded hop instead of staged decode -> add -> requantize ops:

``hop_absmax``      K1: global ``max|x|`` (replaces ``_absmax_kernel``)
``hop_encode``      K2: absmax + quantize, producing the wire payload and
                    its f32 scale (replaces ``_bf16/_int8/_fp8_encode_kernel``)
``hop_decode_add``  K3: ``payload.f32 * scale (+ add)`` in one pass
                    (replaces ``_make_decode_add``)

Each wrapper takes the plain torch version (``*_plain`` below, the same
arithmetic as ``core/codec.py``'s encode/decode) only for a tensor on the
CPU; for a CUDA tensor it launches the kernel of ``csrc/fused_hop.cu`` or
raises.  The plain versions run under the flush-to-zero guard on the CPU,
matching the reference's XLA arithmetic bit for bit.

Bounds on the card (device-memory bytes; the flops are negligible):
K1 reads 4n; K2 reads 4n and writes n (int8/fp8) or 2n (bf16); K3 reads
the payload (n..4n) and the partial (4n) and writes 4n.  K1 and K3 are
plain grid-stride passes; K2 moves 16-byte vectors when ``x`` is 16-byte
aligned (:func:`backend.vector_aligned`) and takes its scalar loop
otherwise; see the CUDA source.

Every wrapper counts its launches in ``<wrapper>.launches``;
``hop_encode.scalar_launches`` counts the K2 launches that took the
scalar loop.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import backend

HOP_CODECS = ("none", "bf16", "int8", "fp8_e4m3")

_WIRE_DTYPE = {"bf16": torch.bfloat16, "int8": torch.int8,
               "fp8_e4m3": torch.float8_e4m3fn}
_CODEC_CODE = {"bf16": 1, "int8": 2, "fp8_e4m3": 3}
_PAYLOAD_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                 torch.float8_e4m3fn: 3}
_DENOM = {"int8": 127.0, "fp8_e4m3": 448.0}
_TINY = torch.finfo(torch.float32).tiny


def _check_name(name: str) -> None:
    if name not in HOP_CODECS:
        raise ValueError(f"unknown hop codec {name!r}; one of {HOP_CODECS}")


def _host_guard(t: torch.Tensor):
    return backend.flush_denormal() if t.device.type == "cpu" \
        else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Plain versions (CPU path, tests, and the card-side comparison)
# ---------------------------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` in f32 with a subnormal result flushed to zero."""
    with _host_guard(x):
        a = x.to(torch.float32).abs().amax()
        return torch.where(a < _TINY, torch.zeros_like(a), a)


def encode_plain(name: str, x: torch.Tensor):
    """``(payload, scale)`` — core/codec.py's encode, term for term."""
    _check_name(name)
    if name == "none":
        return x, None
    if name == "bf16":
        return x.to(torch.bfloat16), None
    xf = x.to(torch.float32)
    with _host_guard(xf):
        absmax = absmax_plain(xf)
        safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
        # A 0-d tensor divisor, not a Python number: torch divides by a
        # host scalar as a multiply by its reciprocal on CUDA.
        denom = torch.tensor(_DENOM[name], dtype=torch.float32,
                             device=xf.device)
        scale = torch.clamp_min(safe / denom, _TINY)
        if name == "int8":
            q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
            return q.to(torch.int8), scale
        return (xf / scale).to(torch.float8_e4m3fn), scale


def _out_dtype(name: str, payload: torch.Tensor, add) -> torch.dtype:
    decoded = payload.dtype if name == "none" else torch.float32
    return decoded if add is None else torch.promote_types(decoded, add.dtype)


def decode_add_plain(name: str, payload: torch.Tensor, scale,
                     add: torch.Tensor | None = None) -> torch.Tensor:
    """``decode(payload) * scale (+ add)`` in f32, cast to the promoted
    dtype — core/codec.py's decode followed by the accumulate."""
    _check_name(name)
    if name == "none" and add is None:
        return payload
    if add is not None and add.shape != payload.shape:
        raise ValueError(f"hop add shape {tuple(add.shape)} != payload "
                         f"shape {tuple(payload.shape)}")
    with _host_guard(payload):
        out = payload.to(torch.float32)
        if scale is not None:
            out = out * scale
        if add is not None:
            out = out + add.to(torch.float32)
        return out.to(_out_dtype(name, payload, add))


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, kernel for CUDA tensors
# ---------------------------------------------------------------------------

def _lib():
    lib = backend.load("fused_hop")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hop_absmax_f32.argtypes = [vp, ll, vp, vp]
        lib.hop_encode_f32.argtypes = [i, vp, ll, vp, vp, vp, i, vp]
        lib.hop_decode_add.argtypes = [i, vp, vp, vp, vp, ll, vp]
        for fn in (lib.hop_absmax_f32, lib.hop_encode_f32,
                   lib.hop_decode_add):
            fn.restype = i
        lib._typed = True
    return lib


def _is_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"hop tensors on unsupported/mixed devices {devs}")


def _absmax_launch(xf: torch.Tensor) -> torch.Tensor:
    """Launch K1 into a fresh (1,) uint32 buffer holding the f32 bits."""
    if xf.numel() == 0:
        raise ValueError("hop_absmax of an empty buffer")
    bits = torch.empty(1, dtype=torch.int32, device=xf.device)
    backend.check(_lib().hop_absmax_f32(backend.ptr(xf), xf.numel(),
                                        backend.ptr(bits),
                                        backend.stream_ptr()), "hop_absmax")
    hop_absmax.launches += 1
    return bits


def hop_absmax(x: torch.Tensor) -> torch.Tensor:
    """Global absmax (exact), an f32 scalar tensor."""
    if _is_cpu(x):
        return absmax_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"hop_absmax kernel takes float32, got {x.dtype}")
    backend.check_cuda("hop_absmax", x)
    return _absmax_launch(x).view(torch.float32).reshape(())


hop_absmax.launches = 0


def _encode_launch(name: str, x: torch.Tensor, bits):
    """Launch K2 on ``x`` given K1's absmax bits (``None`` for bf16):
    ``(payload, scale)``."""
    out = torch.empty(x.shape, dtype=_WIRE_DTYPE[name], device=x.device)
    scale = None if bits is None else torch.empty((), dtype=torch.float32,
                                                  device=x.device)
    vec = backend.vector_aligned(x, out)
    backend.check(_lib().hop_encode_f32(
        _CODEC_CODE[name], backend.ptr(x), x.numel(), backend.ptr(bits),
        backend.ptr(out), backend.ptr(scale), int(vec),
        backend.stream_ptr()), "hop_encode")
    hop_encode.launches += 1
    hop_encode.scalar_launches += not vec
    return out, scale


def hop_encode(name: str, x: torch.Tensor):
    """``(payload, scale)`` for the wire — fused twin of codec.encode."""
    _check_name(name)
    if name == "none":
        return x, None
    if _is_cpu(x):
        return encode_plain(name, x)
    if x.dtype != torch.float32:
        raise TypeError(f"hop_encode kernel takes float32, got {x.dtype}")
    backend.check_cuda("hop_encode", x)
    return _encode_launch(name, x,
                          None if name == "bf16" else _absmax_launch(x))


hop_encode.launches = 0
hop_encode.scalar_launches = 0


def hop_decode_add(name: str, payload: torch.Tensor, scale,
                   add: torch.Tensor | None = None) -> torch.Tensor:
    """decode(payload)·scale (+ add) in ONE kernel pass, fp32 internal;
    the result dtype is the unfused ``add + decode(...)`` promotion."""
    _check_name(name)
    if name == "none" and add is None:
        return payload
    if _is_cpu(payload, scale, add):
        return decode_add_plain(name, payload, scale, add)
    if add is not None and add.shape != payload.shape:
        raise ValueError(f"hop add shape {tuple(add.shape)} != payload "
                         f"shape {tuple(payload.shape)}")
    if payload.dtype not in _PAYLOAD_CODE:
        raise TypeError(f"hop_decode_add kernel: payload dtype "
                        f"{payload.dtype} not in {list(_PAYLOAD_CODE)}")
    if add is not None and add.dtype != torch.float32:
        raise TypeError(f"hop_decode_add kernel: add must be float32, "
                        f"got {add.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise TypeError("hop_decode_add kernel: scale must be one float32")
    if _out_dtype(name, payload, add) != torch.float32:
        raise TypeError("hop_decode_add kernel writes float32 only")
    backend.check_cuda("hop_decode_add", payload,
                       *(t for t in (scale, add) if t is not None))
    out = torch.empty(payload.shape, dtype=torch.float32,
                      device=payload.device)
    backend.check(_lib().hop_decode_add(
        _PAYLOAD_CODE[payload.dtype], backend.ptr(payload),
        backend.ptr(scale), backend.ptr(add), backend.ptr(out),
        payload.numel(), backend.stream_ptr()), "hop_decode_add")
    hop_decode_add.launches += 1
    return out


hop_decode_add.launches = 0
