"""Decoder-only transformer LM, dense GQA (counterpart of the dense path
of ``repro/models/transformer.py``).

Parameters keep the reference's nested-dict names, float32 dtype and
stacked-layer leading dim (``body/*`` has shape ``(L, ...)``), so the
reference's parameter tree loads unchanged (``convert.py``) and gradient
leaves flatten into the same fusion buckets.  The reference scans the
layer stack; here a Python loop walks ``unbind`` views of it, whose
backward writes each stacked gradient once.

Serving (the reference's KV-cache functions): :func:`init_cache` makes
``{"body": {"k", "v"}, "pos"}`` with ``k``/``v`` of shape ``(L, B,
cache_len, KV, dh)`` in the compute dtype and ``pos`` a host int32
scalar; :func:`prefill` runs :func:`forward` over the prompt, seeds the
cache and returns the last position's logits; :func:`decode_step` runs
one token, writing each layer's cache slot in place.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import tree as tree_mod
from .attention import gqa_decode, gqa_forward, gqa_params
from .common import (ModelSpec, ParamTree, cross_entropy, embed_init, norm,
                     norm_params)
from .mlp import mlp_forward, mlp_params


def _check_supported(spec: ModelSpec) -> None:
    if spec.family != "dense" or spec.attention_type != "gqa" \
            or spec.num_experts:
        raise NotImplementedError(
            f"{spec.name}: only the dense GQA family is ported yet")
    if spec.seq_parallel or spec.remat:
        raise NotImplementedError("seq_parallel/remat are not ported yet")


def _layer_params(gen, spec: ModelSpec, device) -> dict:
    return {
        "ln1": norm_params(spec.d_model, spec.norm_type, device),
        "ln2": norm_params(spec.d_model, spec.norm_type, device),
        "attn": gqa_params(gen, spec, device),
        "mlp": mlp_params(gen, spec.d_model, spec.d_ff, spec.mlp_type,
                          device),
    }


def init_params(gen: torch.Generator, spec: ModelSpec, device=None) -> dict:
    """Random parameters from a seeded generator (on ``device``)."""
    _check_supported(spec)
    # Each layer is drawn in turn and copied into the stacked leaves, so
    # the stack never sits beside a second copy of itself (a full-depth
    # gemma-7b is 34 GB in f32).
    body = None
    for i in range(spec.num_layers):
        layer = _layer_params(gen, spec, device)
        if body is None:
            body = tree_mod.tree_map(lambda x: torch.empty(
                (spec.num_layers,) + tuple(x.shape), dtype=x.dtype,
                device=x.device), layer)
        for stacked, x in zip(tree_mod.leaves(body), tree_mod.leaves(layer)):
            stacked[i].copy_(x)
    params = {
        "embed": embed_init(gen, (spec.padded_vocab, spec.d_model), device),
        "body": body,
        "ln_f": norm_params(spec.d_model, spec.norm_type, device),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = embed_init(gen, (spec.d_model,
                                             spec.padded_vocab), device)
    return params


def _block_forward(lp, h, positions, spec: ModelSpec):
    """One pre-norm block, full sequence.  Returns ``(h, (k, v))``."""
    a_in = norm(h, lp["ln1"], spec.norm_type)
    a_out, kv = gqa_forward(lp["attn"], a_in, positions, spec)
    h = h + a_out
    m_in = norm(h, lp["ln2"], spec.norm_type)
    return h + mlp_forward(lp["mlp"], m_in, spec.mlp_type), kv


def _block_decode(lp, h, cache_k, cache_v, pos: int, spec: ModelSpec):
    a_in = norm(h, lp["ln1"], spec.norm_type)
    h = h + gqa_decode(lp["attn"], a_in, cache_k, cache_v, pos, spec)
    m_in = norm(h, lp["ln2"], spec.norm_type)
    return h + mlp_forward(lp["mlp"], m_in, spec.mlp_type)


def _layers(tree, n: int) -> list:
    """``n`` per-layer trees of ``unbind`` views of a stacked tree."""
    views = tree_mod.tree_map(lambda w: w.unbind(0), tree)
    return [tree_mod.tree_map(lambda ws: ws[i], views) for i in range(n)]


def embed_tokens(params, tokens, spec: ModelSpec):
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens]
    if spec.scale_embed:
        h = h * torch.sqrt(torch.tensor(float(spec.d_model))).to(cd)
    return h


def lm_logits(params, h, spec: ModelSpec):
    cd = spec.compute_dtype
    if spec.tie_embeddings or "lm_head" not in params:
        return h @ params["embed"].to(cd).T
    return h @ params["lm_head"].to(cd)


def forward(params, tokens, spec: ModelSpec, collect_cache: bool = False):
    """Logits (B, S, V_padded) for tokens (B, S); with ``collect_cache``
    ``(logits, kv)``, ``kv`` each layer's ``(k, v)`` (B, S, KV, dh)."""
    _check_supported(spec)
    b = tokens.shape[0]
    h = embed_tokens(params, tokens, spec)
    s = h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    kvs = []
    for lp in _layers(params["body"], spec.num_layers):
        h, kv = _block_forward(lp, h, positions, spec)
        if collect_cache:
            kvs.append(kv)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = lm_logits(params, h, spec)
    return (logits, kvs) if collect_cache else logits


def loss_fn(params, batch, spec: ModelSpec):
    """``(loss, metrics)`` as the reference's ``loss_fn`` (dense: no
    router aux loss, so ``aux`` and ``drop`` are zero)."""
    logits = forward(params, batch["tokens"], spec)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    total = loss + spec.router_aux_weight * zero
    return total, {"ce": loss, "aux": zero, "drop": zero}


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_len(spec: ModelSpec, seq: int) -> int:
    return min(seq, spec.sliding_window) if spec.sliding_window else seq


def init_cache(spec: ModelSpec, batch: int, seq: int, device=None) -> dict:
    """A zeros cache for ``batch`` rows and ``seq`` positions."""
    _check_supported(spec)
    shape = (spec.num_layers, batch, cache_len(spec, seq),
             spec.num_kv_heads, spec.resolved_head_dim)
    cd = spec.compute_dtype
    return {"body": {"k": torch.zeros(shape, dtype=cd, device=device),
                     "v": torch.zeros(shape, dtype=cd, device=device)},
            "pos": torch.zeros((), dtype=torch.int32)}


def prefill(params, tokens, spec: ModelSpec, max_seq=None):
    """Run the prompt, build the cache for ``max_seq`` positions (the
    prompt's length by default), return ``(logits[:, -1], cache)``."""
    logits, kvs = forward(params, tokens, spec, collect_cache=True)
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(spec, b, max_seq, device=tokens.device)
    cl = cache_len(spec, max_seq)
    for i, kv in enumerate(kvs):
        for buf, x in zip((cache["body"]["k"][i], cache["body"]["v"][i]),
                          kv):
            # keep the trailing window under a sliding window
            take = x[:, -cl:] if x.shape[1] > cl else x
            buf[:, :take.shape[1]] = take
    del kvs
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    # a copy: a view would keep the (B, S, V) logits alive
    return logits[:, -1].clone(), cache


def decode_step(params, cache, tokens, spec: ModelSpec):
    """One decode step.  tokens (B, 1).  Returns ``(logits (B, V),
    cache)``: the same buffers, each layer's slot written in place, and
    ``pos`` one further."""
    _check_supported(spec)
    pos = int(cache["pos"])
    h = embed_tokens(params, tokens, spec)
    ks = cache["body"]["k"].unbind(0)
    vs = cache["body"]["v"].unbind(0)
    for i, lp in enumerate(_layers(params["body"], spec.num_layers)):
        h = _block_decode(lp, h, ks[i], vs[i], pos, spec)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = lm_logits(params, h, spec)[:, 0]
    return logits, {**cache, "pos": torch.tensor(pos + 1,
                                                 dtype=torch.int32)}


class TransformerLM(nn.Module):
    """The model as a module: its parameters under the reference's
    names; ``forward(batch)`` returns ``(loss, metrics)``."""

    def __init__(self, spec: ModelSpec, params: dict):
        super().__init__()
        _check_supported(spec)
        self.spec = spec
        self.params = ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, batch):
        return loss_fn(self.tree(), batch, self.spec)
