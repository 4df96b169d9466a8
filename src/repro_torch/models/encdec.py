"""Whisper-style encoder-decoder (counterpart of
``repro/models/encdec.py``; the whisper-tiny backbone).

The mel-spectrogram and conv front end is a stub, as in the reference:
``extra_inputs`` gives precomputed frame embeddings ``(batch,
encoder_seq, d_model)``.  Positions are sinusoidal on both sides (the
reference's deviation from Whisper's learned decoder positions), norms
are LayerNorm in plain torch (not K6).

The encoder's bidirectional attention is the reference's ``sdpa_full``
with every query at position ``S - 1``, so it never takes the flash
path, even at 1500 frames.  The decoder's self-attention is
``gqa_forward`` without rope (K7/K8 above ``attn_full_seq_max``), its
cross-attention plain with an f32 softmax.  Serving: the cache holds
``self_k``/``self_v`` (L, B, S, KV, dh), written in place by
:func:`decode_step`, and the encoder's keys and values for every decoder
layer, ``cross_k``/``cross_v`` (L, B, frames, KV, dh), made once by
:func:`prefill`.
"""
from __future__ import annotations

import math

import torch

from .attention import gqa_decode, gqa_forward, gqa_params, sdpa_full
from .common import (ModelSpec, cross_entropy, embed_init, layer_views, norm,
                     norm_params, sinusoidal_positions, stack_layers)
from .mlp import mlp_forward, mlp_params


def _enc_layer(gen, spec: ModelSpec, device):
    d = spec.d_model
    return {
        "ln1": norm_params(d, spec.norm_type, device),
        "attn": gqa_params(gen, spec, device),
        "ln2": norm_params(d, spec.norm_type, device),
        "mlp": mlp_params(gen, d, spec.d_ff, spec.mlp_type, device),
    }


def _dec_layer(gen, spec: ModelSpec, device):
    d = spec.d_model
    return {
        "ln1": norm_params(d, spec.norm_type, device),
        "self_attn": gqa_params(gen, spec, device),
        "ln_x": norm_params(d, spec.norm_type, device),
        "cross_attn": gqa_params(gen, spec, device),
        "ln2": norm_params(d, spec.norm_type, device),
        "mlp": mlp_params(gen, d, spec.d_ff, spec.mlp_type, device),
    }


def init_params(gen: torch.Generator, spec: ModelSpec, device=None) -> dict:
    return {
        "embed": embed_init(gen, (spec.padded_vocab, spec.d_model), device),
        "encoder": stack_layers(spec.encoder_layers,
                                lambda: _enc_layer(gen, spec, device)),
        "enc_ln": norm_params(spec.d_model, spec.norm_type, device),
        "decoder": stack_layers(spec.num_layers,
                                lambda: _dec_layer(gen, spec, device)),
        "ln_f": norm_params(spec.d_model, spec.norm_type, device),
    }


def _positions(seq: int, spec: ModelSpec, device, start: int = 0):
    return torch.from_numpy(sinusoidal_positions(
        seq, spec.d_model, start)).to(device=device, dtype=spec.compute_dtype)


def _qkv(p, x, spec: ModelSpec):
    b, s, _ = x.shape
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(cd)).reshape(b, s, kvh, hd)
    v = (x @ p["wv"].to(cd)).reshape(b, s, kvh, hd)
    return q, k, v


def _proj_out(p, a, spec: ModelSpec):
    b, s = a.shape[:2]
    return a.reshape(b, s, -1) @ p["wo"].to(spec.compute_dtype)


def _cross_attention(params, x, enc_k, enc_v, spec: ModelSpec):
    """Unmasked attention of the decoder's x over the encoder's K/V."""
    b, s, _ = x.shape
    h, kvh, hd = spec.num_heads, spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(b, s, h, hd)
    kr = torch.repeat_interleave(enc_k, h // kvh, dim=2)
    vr = torch.repeat_interleave(enc_v, h // kvh, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32)
    probs = torch.softmax(sc / math.sqrt(float(hd)), dim=-1).to(cd)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    return out.reshape(b, s, h * hd) @ params["wo"].to(cd)


def encode(params, frames, spec: ModelSpec):
    """frames (B, encoder_seq, d_model) stub embeddings -> encoder states."""
    cd = spec.compute_dtype
    s = frames.shape[1]
    h = frames.to(cd) + _positions(s, spec, frames.device)
    # Bidirectional: sdpa_full with every query at the last position.
    qpos = torch.full((s,), s - 1, dtype=torch.int32, device=frames.device)
    kpos = torch.arange(s, dtype=torch.int32, device=frames.device)
    for lp in layer_views(params["encoder"], spec.encoder_layers):
        a_in = norm(h, lp["ln1"], spec.norm_type)
        q, k, v = _qkv(lp["attn"], a_in, spec)
        h = h + _proj_out(lp["attn"], sdpa_full(q, k, v, qpos, kpos, 0),
                          spec)
        m_in = norm(h, lp["ln2"], spec.norm_type)
        h = h + mlp_forward(lp["mlp"], m_in, spec.mlp_type)
    return norm(h, params["enc_ln"], spec.norm_type)


def _enc_kv(lp, enc_out, spec: ModelSpec):
    """One decoder layer's cross-attention K/V: (B, frames, KV, dh)."""
    b, s, _ = enc_out.shape
    kvh, hd = spec.num_kv_heads, spec.resolved_head_dim
    cd = spec.compute_dtype
    k = (enc_out @ lp["cross_attn"]["wk"].to(cd)).reshape(b, s, kvh, hd)
    v = (enc_out @ lp["cross_attn"]["wv"].to(cd)).reshape(b, s, kvh, hd)
    return k, v


def _decoder_rest(lp, h, ek, ev, spec: ModelSpec):
    """Cross-attention and the MLP after a decoder layer's
    self-attention."""
    x_in = norm(h, lp["ln_x"], spec.norm_type)
    h = h + _cross_attention(lp["cross_attn"], x_in, ek, ev, spec)
    m_in = norm(h, lp["ln2"], spec.norm_type)
    return h + mlp_forward(lp["mlp"], m_in, spec.mlp_type)


def decoder_forward(params, tokens, enc_out, spec: ModelSpec, cache=None):
    """Logits (B, S, V_padded).  With ``cache`` (:func:`init_cache`'s)
    each layer's self-attention keys and values and its cross-attention
    K/V are written into it."""
    b, s = tokens.shape
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens] + _positions(s, spec, tokens.device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    for i, lp in enumerate(layer_views(params["decoder"], spec.num_layers)):
        ek, ev = _enc_kv(lp, enc_out, spec)
        a_in = norm(h, lp["ln1"], spec.norm_type)
        a_out, (k, v) = gqa_forward(lp["self_attn"], a_in, positions, spec,
                                    rope=False)
        h = _decoder_rest(lp, h + a_out, ek, ev, spec)
        if cache is not None:
            cache["self_k"][i, :, :s] = k
            cache["self_v"][i, :, :s] = v
            cache["cross_k"][i] = ek
            cache["cross_v"][i] = ev
    h = norm(h, params["ln_f"], spec.norm_type)
    return h @ params["embed"].to(cd).T


def loss_fn(params, batch, spec: ModelSpec):
    enc_out = encode(params, batch["frames"], spec)
    logits = decoder_forward(params, batch["tokens"], enc_out, spec)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss}


def init_cache(spec: ModelSpec, batch: int, seq: int, device=None) -> dict:
    """Zeros for ``batch`` rows, ``seq`` text positions and the
    ``encoder_seq`` frames."""
    cd = spec.compute_dtype
    kv = (spec.num_kv_heads, spec.resolved_head_dim)
    n = spec.num_layers
    es = spec.encoder_seq
    return {
        "self_k": torch.zeros((n, batch, seq) + kv, dtype=cd, device=device),
        "self_v": torch.zeros((n, batch, seq) + kv, dtype=cd, device=device),
        "cross_k": torch.zeros((n, batch, es) + kv, dtype=cd, device=device),
        "cross_v": torch.zeros((n, batch, es) + kv, dtype=cd, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def prefill(params, tokens, frames, spec: ModelSpec, max_seq=None):
    """Encode ``frames``, run the prompt, build the cache for ``max_seq``
    text positions (the prompt's by default), return ``(logits[:, -1],
    cache)``.  A prompt longer than the cache raises ``ValueError``."""
    b, s = tokens.shape
    max_seq = max_seq or s
    if s > max_seq:
        raise ValueError(f"{spec.name}: a prompt of {s} tokens does not "
                         f"fit a cache of max_seq {max_seq}")
    enc_out = encode(params, frames, spec)
    cache = init_cache(spec, b, max_seq, device=tokens.device)
    logits = decoder_forward(params, tokens, enc_out, spec, cache=cache)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    # a copy: a view would keep the (B, S, V) logits alive
    return logits[:, -1].clone(), cache


def decode_step(params, cache, tokens, spec: ModelSpec):
    """One decode step.  tokens (B, 1).  Returns ``(logits (B, V),
    cache)``: the same buffers, the self-attention slots written in
    place, and ``pos`` one further."""
    cd = spec.compute_dtype
    pos = int(cache["pos"])
    smax = cache["self_k"].shape[2]
    row = min(pos, smax - 1)
    h = params["embed"].to(cd)[tokens] \
        + _positions(row + 1, spec, tokens.device, start=row)
    for i, lp in enumerate(layer_views(params["decoder"], spec.num_layers)):
        a_in = norm(h, lp["ln1"], spec.norm_type)
        a_out = gqa_decode(lp["self_attn"], a_in, cache["self_k"][i],
                           cache["self_v"][i], pos, spec, rope=False)
        h = _decoder_rest(lp, h + a_out, cache["cross_k"][i],
                          cache["cross_v"][i], spec)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = (h @ params["embed"].to(cd).T)[:, 0]
    return logits, {**cache, "pos": torch.tensor(pos + 1,
                                                 dtype=torch.int32)}
