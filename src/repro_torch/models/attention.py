"""GQA attention, full-sequence (counterpart of the dense path of
``repro/models/attention.py``).

Attention is the reference's ``sdpa_full``: plain masked attention in
torch, with an fp32 softmax, as the reference leaves it outside any
kernel.  Sequences longer than ``spec.attn_full_seq_max`` take the
reference's flash path, whose kernels (K7/K8) are not ported yet, so
they raise.  MLA, sliding-window decode and KV caches come with serving.
"""
from __future__ import annotations

import math

import torch

from .common import ModelSpec, apply_rope, dense_init

NEG_INF = -1e30


def gqa_params(gen, spec: ModelSpec, device=None) -> dict:
    d, h, kv, hd = spec.d_model, spec.num_heads, spec.num_kv_heads, \
        spec.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, h * hd), device=device),
        "wk": dense_init(gen, (d, kv * hd), device=device),
        "wv": dense_init(gen, (d, kv * hd), device=device),
        "wo": dense_init(gen, (h * hd, d), device=device),
    }


def _mask_bias(q_pos, k_pos, window: int):
    """(Sq, Sk) additive mask: causal, optionally sliding-window."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def sdpa_full(q, k, v, q_pos, k_pos, window: int = 0):
    """Plain attention. q (B,Sq,H,dh); k,v (B,Sk,KV,dh). fp32 softmax."""
    dh = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(dh) + _mask_bias(q_pos, k_pos, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa(q, k, v, q_pos, k_pos, spec: ModelSpec, window: int = 0):
    if q.shape[1] <= spec.attn_full_seq_max and \
            k.shape[1] <= spec.attn_full_seq_max:
        return sdpa_full(q, k, v, q_pos, k_pos, window)
    raise NotImplementedError(
        f"sequence {q.shape[1]} > attn_full_seq_max "
        f"{spec.attn_full_seq_max}: the flash-attention kernels (K7/K8) "
        f"are not ported yet")


def gqa_forward(params, x, positions, spec: ModelSpec, rope: bool = True):
    """Full-sequence GQA. x (B,S,d). Returns (out, (k, v))."""
    b, s, _ = x.shape
    h, kv, hd = spec.num_heads, spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(cd)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].to(cd)).reshape(b, s, kv, hd)
    if rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    out = sdpa(q, k, v, positions[0], positions[0], spec,
               window=spec.sliding_window)
    out = out.reshape(b, s, h * hd) @ params["wo"].to(cd)
    return out, (k, v)
