"""Zamba2-style hybrid (counterpart of ``repro/models/hybrid.py``): a
Mamba2 backbone and one weight-SHARED attention block applied after
every ``attn_every`` Mamba2 layers (arXiv:2411.15242).

The shared block sees ``concat(hidden, first embedding)`` (Zamba's
global residual) through an RMSNorm over ``2·d_model`` (K6; 4096 values
a row at zamba2-1.2b's width) and an input projection back to
``d_model``, then GQA attention (``gqa_forward``: K7/K8 above
``attn_full_seq_max``) and a SwiGLU MLP.  Its weights are shared by every
application, so autograd sums their gradients over the applications;
each application keeps a KV cache of its own for decode.

The tree keeps the reference's names: ``mamba/{ln, mixer/*}`` stacked
over the layers, ``shared/{ln1, in_proj, attn, ln2, mlp}``, ``embed``
(tied logits) and ``ln_f``.  Serving: :func:`init_cache` makes
``attn_k``/``attn_v`` (applications, B, S, KV, dh) in the compute dtype,
``ssm`` (the stacked :func:`~.mamba2.mamba2_init_state`) and ``pos``, a
host int32 scalar; :func:`prefill` writes them, :func:`decode_step`
updates them in place.
"""
from __future__ import annotations

import torch

from . import mamba2
from .attention import gqa_decode, gqa_forward, gqa_params
from .common import (ModelSpec, cross_entropy, dense_init, embed_init,
                     layer_views, norm, norm_params, stack_layers)
from .mlp import mlp_forward, mlp_params


def _n_apps(spec: ModelSpec) -> int:
    return spec.num_layers // spec.attn_every


def _group_bounds(spec: ModelSpec):
    """``[(start, end)]`` Mamba2-layer slices between the shared block's
    applications (a shorter tail group when ``attn_every`` does not
    divide the depth: 2 layers at zamba2-1.2b's 38)."""
    k = spec.attn_every
    bounds = []
    start = 0
    for _ in range(_n_apps(spec)):
        bounds.append((start, start + k))
        start += k
    if start < spec.num_layers:
        bounds.append((start, spec.num_layers))
    return bounds


def init_params(gen: torch.Generator, spec: ModelSpec, device=None) -> dict:
    d = spec.d_model
    return {
        "embed": embed_init(gen, (spec.padded_vocab, d), device),
        "mamba": stack_layers(spec.num_layers, lambda: {
            "ln": norm_params(d, spec.norm_type, device),
            "mixer": mamba2.mamba2_params(gen, spec, device)}),
        "shared": {
            "ln1": norm_params(2 * d, spec.norm_type, device),
            "in_proj": dense_init(gen, (2 * d, d), device=device),
            "attn": gqa_params(gen, spec, device),
            "ln2": norm_params(d, spec.norm_type, device),
            "mlp": mlp_params(gen, d, spec.d_ff, spec.mlp_type, device),
        },
        "ln_f": norm_params(d, spec.norm_type, device),
    }


def _shared_in(params, h, emb0, spec: ModelSpec):
    x = torch.cat([h, emb0], dim=-1)
    x = norm(x, params["ln1"], spec.norm_type)
    return x @ params["in_proj"].to(h.dtype)


def _shared_out(params, h, spec: ModelSpec):
    m_in = norm(h, params["ln2"], spec.norm_type)
    return h + mlp_forward(params["mlp"], m_in, spec.mlp_type)


def _shared_block(params, h, emb0, positions, spec: ModelSpec):
    a_out, kv = gqa_forward(params["attn"], _shared_in(params, h, emb0, spec),
                            positions, spec)
    return _shared_out(params, h + a_out, spec), kv


def _shared_block_decode(params, h, emb0, ck, cv, pos: int,
                         spec: ModelSpec):
    a_out = gqa_decode(params["attn"], _shared_in(params, h, emb0, spec),
                       ck, cv, pos, spec)
    return _shared_out(params, h + a_out, spec)


def forward(params, tokens, spec: ModelSpec, cache=None):
    """Logits (B, S, V_padded).  With ``cache`` (:func:`init_cache`'s)
    each Mamba2 layer's final state and each application's keys and
    values are written into it."""
    b, s = tokens.shape
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens]
    emb0 = h
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    layers = layer_views(params["mamba"], spec.num_layers)
    for gi, (a, bnd) in enumerate(_group_bounds(spec)):
        for i in range(a, bnd):
            lp = layers[i]
            out, st = mamba2.mamba2_forward(
                lp["mixer"], norm(h, lp["ln"], spec.norm_type), spec)
            h = h + out
            if cache is not None:
                for key, x in st.items():
                    cache["ssm"][key][i].copy_(x)
        if gi < _n_apps(spec):
            h, (k, v) = _shared_block(params["shared"], h, emb0, positions,
                                      spec)
            if cache is not None:
                cache["attn_k"][gi, :, :s] = k
                cache["attn_v"][gi, :, :s] = v
    h = norm(h, params["ln_f"], spec.norm_type)
    return h @ params["embed"].to(cd).T              # tied embeddings


def loss_fn(params, batch, spec: ModelSpec):
    logits = forward(params, batch["tokens"], spec)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss}


def init_cache(spec: ModelSpec, batch: int, seq: int, device=None) -> dict:
    cd = spec.compute_dtype
    n = _n_apps(spec)
    kv_shape = (n, batch, seq, spec.num_kv_heads, spec.resolved_head_dim)
    one = mamba2.mamba2_init_state(spec, batch, device)
    return {
        "attn_k": torch.zeros(kv_shape, dtype=cd, device=device),
        "attn_v": torch.zeros(kv_shape, dtype=cd, device=device),
        "ssm": {k: torch.zeros((spec.num_layers,) + tuple(x.shape),
                               dtype=x.dtype, device=device)
                for k, x in one.items()},
        "pos": torch.zeros((), dtype=torch.int32),
    }


def prefill(params, tokens, spec: ModelSpec, max_seq=None):
    """Run the prompt, build the cache for ``max_seq`` positions (the
    prompt's by default), return ``(logits[:, -1], cache)``.  A prompt
    longer than the cache raises ``ValueError``."""
    b, s = tokens.shape
    max_seq = max_seq or s
    if s > max_seq:
        raise ValueError(f"{spec.name}: a prompt of {s} tokens does not "
                         f"fit a cache of max_seq {max_seq}")
    cache = init_cache(spec, b, max_seq, device=tokens.device)
    logits = forward(params, tokens, spec, cache=cache)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    # a copy: a view would keep the (B, S, V) logits alive
    return logits[:, -1].clone(), cache


def decode_step(params, cache, tokens, spec: ModelSpec):
    """One decode step.  tokens (B, 1).  Returns ``(logits (B, V),
    cache)``: the same buffers, written in place, and ``pos`` one
    further."""
    cd = spec.compute_dtype
    pos = int(cache["pos"])
    h = params["embed"].to(cd)[tokens]
    emb0 = h
    layers = layer_views(params["mamba"], spec.num_layers)
    for gi, (a, bnd) in enumerate(_group_bounds(spec)):
        for i in range(a, bnd):
            lp = layers[i]
            st = {k: x[i] for k, x in cache["ssm"].items()}
            out, _ = mamba2.mamba2_decode(
                lp["mixer"], norm(h, lp["ln"], spec.norm_type), st, spec)
            h = h + out
        if gi < _n_apps(spec):
            h = _shared_block_decode(params["shared"], h, emb0,
                                     cache["attn_k"][gi],
                                     cache["attn_v"][gi], pos, spec)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = (h @ params["embed"].to(cd).T)[:, 0]
    return logits, {**cache, "pos": torch.tensor(pos + 1,
                                                 dtype=torch.int32)}
