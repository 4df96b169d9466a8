"""Plain-torch oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

:func:`fused_reduce_ref` is K4's oracle, the reference's formula: one
``torch.sum`` in f32 (its own summation order, so it agrees with the
kernel within rounding, not bit for bit).  The oracle of K5 is the plain version that lives beside its kernel in
``fused_adamw.py``; it is the same function, term for term, as the
reference's ``adamw_update_ref``.  Likewise ``rmsnorm_ref`` is K6's
plain version.  :func:`flash_attention_ref` is naive masked attention
(the whole score matrix, f32 softmax), the oracle of K7/K8 and of their
chunked plain versions.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import NEG_INF
from .fused_adamw import adamw_update_plain as adamw_update_ref
from .fused_rmsnorm import rmsnorm_plain


def fused_reduce_ref(x, out_dtype=None):
    """``(k, n) -> (n,)`` sum with f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    return torch.sum(x.to(torch.float32), dim=0).to(out_dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """``x·rsqrt(mean(x²)+eps)·(1+scale)`` with f32 statistics."""
    return rmsnorm_plain(x, scale, eps)[0]


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive masked attention, f32 softmax.  (B,S,H,dh) all-H inputs."""
    sq, sk, dh = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = s / math.sqrt(dh)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)) \
        .to(q.dtype)


__all__ = ["adamw_update_ref", "flash_attention_ref", "fused_reduce_ref",
           "rmsnorm_ref"]
