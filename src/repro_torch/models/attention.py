"""GQA and MLA attention (counterpart of ``repro/models/attention.py``).

Short sequences (both sides at most ``spec.attn_full_seq_max``) take the
reference's ``sdpa_full``: plain masked attention in torch with an f32
softmax, as the reference leaves it outside any kernel.  Longer ones
take :func:`sdpa_chunked`, the reference's flash path: kv heads repeated
to the query heads, then :class:`~repro_torch.kernels.FlashAttnFn` — K7
forward and K8 backward on CUDA, the chunked plain versions (chunk
``spec.attn_chunk``) on the CPU.  The full-sequence positions are
``0..S-1`` (``transformer.forward`` builds them so), which is what the
kernels assume.

Under sequence parallelism (``seq``, a :class:`~.common.SeqSplit`) each
model rank projects its chunk of the sequence, ropes it at its global
positions and gathers the keys and values of the whole sequence along
it (GQA's K and V after RoPE, before the kv-head repeat; MLA's latent
``(c_kv, k_rope)``, ``r + rd`` values a token); its queries attend at
their offset (K7/K8's ``q_offset``).  The route between ``sdpa_full``
and the flash path is chosen by the whole sequence's length, as the
reference, which sees the whole sequence, chooses it.

:func:`gqa_decode` is the reference's one-token decode against a KV
cache (plain torch, as the reference computes it outside any kernel):
it writes the new key and value into the preallocated cache in place,
the port's form of the reference's donated cache.

MLA (multi-head latent attention, DeepSeek-V2): :func:`mla_forward` is
the reference's non-absorbed expansion, a full ``(B, H, S, S)`` f32
softmax under the causal mask at every length (the reference runs it
outside any kernel, so no flash kernel here); :func:`mla_decode` is its
absorbed decode in latent space, against a cache of ``(c_kv, k_rope)``,
``r + rd`` values a token.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import FlashAttnFn
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


def mla_params(gen, spec: ModelSpec, device=None) -> dict:
    d, h = spec.d_model, spec.num_heads
    r, rd, nd, vd = spec.kv_lora_rank, spec.qk_rope_dim, spec.qk_nope_dim, \
        spec.v_head_dim
    return {
        "wq": dense_init(gen, (d, h * (nd + rd)), device=device),
        # the latent and the shared rope key
        "wdkv": dense_init(gen, (d, r + rd), device=device),
        "wuk": dense_init(gen, (r, h * nd), device=device),
        "wuv": dense_init(gen, (r, h * vd), device=device),
        "wo": dense_init(gen, (h * vd, d), device=device),
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


def sdpa_chunked(q, k, v, window: int, q_chunk: int, q_offset: int = 0):
    """Flash attention (the reference's ``sdpa_chunked``): no (S, S)
    score tensor in either pass.  q (B,Sq,H,dh) at positions
    ``q_offset..``; k,v (B,Sk,KV,dh) at positions 0..Sk-1.  The kv heads
    are repeated to H here, so autograd sums their gradients back over
    each group, as ``jnp.repeat`` does; a ragged length is padded inside
    the plain version and masked in the kernels."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    return FlashAttnFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             True, window, q_chunk, q_offset)


def sdpa(q, k, v, q_pos, k_pos, spec: ModelSpec, window: int = 0,
         seq=None):
    """``sdpa_full`` when the sequence (its whole length under ``seq``)
    is at most ``attn_full_seq_max``, else the flash path."""
    q_len = q.shape[1] if seq is None else seq.total
    if q_len <= spec.attn_full_seq_max and \
            k.shape[1] <= spec.attn_full_seq_max:
        return sdpa_full(q, k, v, q_pos, k_pos, window)
    return sdpa_chunked(q, k, v, window, spec.attn_chunk,
                        0 if seq is None else seq.offset)


def gqa_forward(params, x, positions, spec: ModelSpec, rope: bool = True,
                seq=None):
    """Full-sequence GQA. x (B,S,d) (under ``seq`` this rank's chunk, at
    ``positions``). Returns (out, (k, v)), k and v of the whole
    sequence."""
    b, s, _ = x.shape
    h, kv, hd = spec.num_heads, spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(cd)).reshape(b, s, kv, hd)
    v = (x @ params["wv"].to(cd)).reshape(b, s, kv, hd)
    if rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    k_pos = positions[0]
    if seq is not None:
        k, v = seq.gather(k), seq.gather(v)
        k_pos = torch.arange(seq.total, dtype=positions.dtype,
                             device=x.device)
    out = sdpa(q, k, v, positions[0], k_pos, spec,
               window=spec.sliding_window, seq=seq)
    out = out.reshape(b, s, h * hd) @ params["wo"].to(cd)
    return out, (k, v)


def gqa_decode(params, x, cache_k, cache_v, pos: int, spec: ModelSpec,
               rope: bool = True):
    """One-token decode.  x (B,1,d); cache_k/v (B,Smax,KV,dh), a ring
    buffer under a sliding window, else linear; ``pos`` the current
    position.  Writes the token's key and value into the caches in place
    and returns the attention output (B,1,d)."""
    b = x.shape[0]
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    smax = cache_k.shape[1]
    q = (x @ params["wq"].to(cd)).reshape(b, 1, h, hd)
    k = (x @ params["wk"].to(cd)).reshape(b, 1, kvh, hd)
    v = (x @ params["wv"].to(cd)).reshape(b, 1, kvh, hd)
    if rope:
        pos_arr = torch.full((b, 1), pos, dtype=torch.int32,
                             device=x.device)
        q = apply_rope(q, pos_arr, spec.rope_theta)
        k = apply_rope(k, pos_arr, spec.rope_theta)
    window = spec.sliding_window
    # The slot the reference's dynamic_update_slice writes: it clamps the
    # index into the buffer.
    slot = pos % smax if window else min(pos, smax - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    # Grouped-query attention without the head repeat: q as
    # (B, 1, KV, rep, dh) against the cache's KV heads.
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache_k) \
        .to(torch.float32) / math.sqrt(hd)
    idx = torch.arange(smax, device=x.device)
    if window:
        valid = (idx <= slot) | (pos >= smax)       # ring buffer full
    else:
        valid = idx <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache_v)
    return out.reshape(b, 1, h * hd) @ params["wo"].to(cd)


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V2); latent KV cache
# ---------------------------------------------------------------------------

def _shared_rope(k_rope, positions, theta: float):
    """RoPE on the rope key that every head shares: (B, S, rd)."""
    return apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]


def mla_forward(params, x, positions, spec: ModelSpec, seq=None):
    """Full-sequence MLA (non-absorbed expansion).  Returns ``(out,
    (c_kv, k_rope))``, the latents for cache seeding.  Under ``seq`` x is
    this rank's chunk and the latents are gathered over the sequence."""
    b, s, _ = x.shape
    h = spec.num_heads
    r, nd, vd = spec.kv_lora_rank, spec.qk_nope_dim, spec.v_head_dim
    rd = spec.qk_rope_dim
    cd = spec.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, spec.rope_theta)

    dkv = x @ params["wdkv"].to(cd)                          # (B, S, r+rd)
    c_kv, k_rope = dkv[..., :r], dkv[..., r:]
    k_rope = _shared_rope(k_rope, positions, spec.rope_theta)
    k_pos = positions[0]
    if seq is not None:
        lat = seq.gather(torch.cat([c_kv, k_rope], dim=-1))
        c_kv, k_rope = lat[..., :r], lat[..., r:]
        k_pos = torch.arange(seq.total, dtype=positions.dtype,
                             device=x.device)
    sk = c_kv.shape[1]
    k_nope = (c_kv @ params["wuk"].to(cd)).reshape(b, sk, h, nd)
    v = (c_kv @ params["wuv"].to(cd)).reshape(b, sk, h, vd)

    # (B, H, S, S) scores: summed, scaled and masked in place (no
    # backward needs them before the softmax), the reference's arithmetic.
    sc = torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope).add_(
        torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)).to(torch.float32)
    sc.mul_(1.0 / math.sqrt(nd + rd)).add_(
        _mask_bias(positions[0], k_pos, 0))
    probs = torch.softmax(sc, dim=-1).to(v.dtype)
    del sc
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(b, s, h * vd) @ params["wo"].to(cd)
    return out, (c_kv, k_rope)


def mla_decode(params, x, cache_c, cache_kr, pos: int, spec: ModelSpec):
    """Absorbed-weight MLA decode: attention in the latent space against
    ``cache_c`` (B, Smax, r) and ``cache_kr`` (B, Smax, rd), which take
    the token's latents in place at slot ``min(pos, Smax - 1)``.  Returns
    the attention output (B, 1, d)."""
    b = x.shape[0]
    h = spec.num_heads
    r, nd, vd = spec.kv_lora_rank, spec.qk_nope_dim, spec.v_head_dim
    rd = spec.qk_rope_dim
    cd = spec.compute_dtype
    smax = cache_c.shape[1]
    q = (x @ params["wq"].to(cd)).reshape(b, 1, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, pos_arr, spec.rope_theta)

    dkv = x @ params["wdkv"].to(cd)
    c_new, kr_new = dkv[..., :r], dkv[..., r:]
    kr_new = _shared_rope(kr_new, pos_arr, spec.rope_theta)
    slot = min(pos, smax - 1)
    cache_c[:, slot] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[:, slot] = kr_new[:, 0].to(cache_kr.dtype)

    # The k up-projection absorbed into the query, per head.
    wuk = params["wuk"].to(cd).reshape(r, h, nd)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)      # (B, 1, H, r)
    sc = (torch.einsum("bqhr,bkr->bhqk", q_lat, cache_c)
          + torch.einsum("bqhd,bkd->bhqk", q_rope, cache_kr)) \
        .to(torch.float32) / math.sqrt(nd + rd)
    valid = torch.arange(smax, device=x.device) <= pos
    sc = torch.where(valid, sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(cache_c.dtype)
    out_lat = torch.einsum("bhqk,bkr->bqhr", probs, cache_c)  # (B, 1, H, r)
    wuv = params["wuv"].to(cd).reshape(r, h, vd)
    out = torch.einsum("bqhr,rhv->bqhv", out_lat, wuv)
    return out.reshape(b, 1, h * vd) @ params["wo"].to(cd)
