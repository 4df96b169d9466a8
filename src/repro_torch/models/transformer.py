"""Decoder-only transformer LM (counterpart of
``repro/models/transformer.py``): the dense (smollm, granite, deepseek-7b,
gemma), MoE (granite-moe, deepseek-v2-lite with MLA) and VLM (the
phi-3-vision backbone) families.

Parameters keep the reference's nested-dict names, float32 dtype and
stacked-layer leading dim (``body/*`` has shape ``(L, ...)``), so the
reference's parameter tree loads unchanged (``convert.py``) and gradient
leaves flatten into the same fusion buckets.  DeepSeek-V2's leading
dense layers are a stack of their own, ``prefix`` (``first_dense_layers``
layers at ``dense_d_ff``), before the uniform MoE ``body``.  The
reference scans the layer stack; here a Python loop walks ``unbind``
views of it, whose backward writes each stacked gradient once; with
``spec.remat`` each body block runs under ``torch.utils.checkpoint``
(the reference's ``jax.checkpoint``) when autograd records.  The VLM
prepends its image-patch embeddings (a stub front end, as in the
reference) to the token embeddings.

Serving (the reference's KV-cache functions): :func:`init_cache` makes
``{"body": {"k", "v"}, "pos"}`` (and ``"prefix"`` beside ``"body"``)
with ``k``/``v`` of shape ``(L, B, cache_len, KV, dh)``, or MLA's
latents ``(L, B, cache_len, r)`` and ``(L, B, cache_len, rd)``, in the
compute dtype, and ``pos`` a host int32 scalar; :func:`prefill` runs
the prompt (after its patches), seeds the cache and returns the last
position's logits; :func:`decode_step` runs one token, writing each
layer's cache slot in place.  Without a sliding window the cache must
hold the whole prompt with its patches: :func:`prefill` raises where
the reference would keep the trailing positions and lose the first
(F8, ROADMAP.md).

Sequence parallelism (``spec.seq_parallel``; the reference's is a GSPMD
constraint ``P(None, "model", None)`` on the residual stream): with a
sequence group (``loss_fn(..., seq_group=)``, the full-manual train
step's model group) each model rank keeps positions ``[r·S/m,
(r+1)·S/m)`` of the embedded sequence (``n_img + S`` for the VLM) and
runs the position-wise work on that chunk: the norms, the dense MLP,
``ln_f``, the logits and the CE.  Attention gathers the keys and values
of the whole sequence (``attention.py``); an MoE layer gathers its
input, dispatches the whole sequence as the reference groups it, and
keeps its chunk's rows.  The loss is this chunk's CE sum over the dp
shard's token count, plus the aux loss on model rank 0 alone (every
rank holds all of it); the model ranks' losses and gradients sum to
the reference's (``core/manual.py``'s boundary sums the gradients).
Without a sequence group ``seq_parallel`` changes nothing, as the
reference's constraint without a model axis.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import moe as moe_lib
from .attention import (gqa_decode, gqa_forward, gqa_params, mla_decode,
                        mla_forward, mla_params)
from .common import (ModelModule, ModelSpec, SeqSplit, cross_entropy,
                     embed_init, layer_views, norm, norm_params,
                     stack_layers)
from .mlp import mlp_forward, mlp_params

FAMILIES = ("dense", "moe", "vlm")


def _check_supported(spec: ModelSpec) -> None:
    if spec.family not in FAMILIES \
            or spec.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{spec.name}: family {spec.family!r} with "
            f"{spec.attention_type!r} attention is not ported yet "
            f"(transformer families: {FAMILIES})")


def _n_prefix(spec: ModelSpec) -> int:
    return spec.first_dense_layers if spec.num_experts else 0


def _layer_params(gen, spec: ModelSpec, device, is_moe: bool,
                  dense_ff: int = 0) -> dict:
    p = {
        "ln1": norm_params(spec.d_model, spec.norm_type, device),
        "ln2": norm_params(spec.d_model, spec.norm_type, device),
        "attn": mla_params(gen, spec, device)
        if spec.attention_type == "mla" else gqa_params(gen, spec, device),
    }
    if is_moe:
        p["moe"] = moe_lib.moe_params(gen, spec, device)
    else:
        p["mlp"] = mlp_params(gen, spec.d_model, dense_ff or spec.d_ff,
                              spec.mlp_type, device)
    return p


def init_params(gen: torch.Generator, spec: ModelSpec, device=None) -> dict:
    """Random parameters from a seeded generator (on ``device``)."""
    _check_supported(spec)
    n_prefix = _n_prefix(spec)
    body_is_moe = spec.num_experts > 0
    params = {
        "body": stack_layers(spec.num_layers - n_prefix, lambda: _layer_params(
            gen, spec, device, body_is_moe)),
        "embed": embed_init(gen, (spec.padded_vocab, spec.d_model), device),
        "ln_f": norm_params(spec.d_model, spec.norm_type, device),
    }
    if n_prefix:
        params["prefix"] = stack_layers(n_prefix, lambda: _layer_params(
            gen, spec, device, False, dense_ff=spec.dense_d_ff or spec.d_ff))
    if not spec.tie_embeddings:
        params["lm_head"] = embed_init(gen, (spec.d_model,
                                             spec.padded_vocab), device)
    return params


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _block_forward(lp, h, positions, spec: ModelSpec, is_moe: bool,
                   seq: "SeqSplit | None" = None):
    """One pre-norm block, full sequence (under ``seq`` this rank's
    chunk).  Returns ``(h, kv, aux, drop)``: ``kv`` the layer's ``(k,
    v)`` (B, S, KV, dh), or MLA's ``(c_kv, k_rope)``."""
    a_in = norm(h, lp["ln1"], spec.norm_type)
    if spec.attention_type == "mla":
        a_out, kv = mla_forward(lp["attn"], a_in, positions, spec, seq=seq)
    else:
        a_out, kv = gqa_forward(lp["attn"], a_in, positions, spec, seq=seq)
    h = h + a_out
    m_in = norm(h, lp["ln2"], spec.norm_type)
    if is_moe and seq is not None:
        # The reference groups the global tokens: dispatch the whole
        # sequence, keep this chunk's rows.
        m_out, aux, drop = moe_lib.moe_forward(lp["moe"], seq.gather(m_in),
                                               spec)
        m_out = seq.narrow(m_out)
    elif is_moe:
        m_out, aux, drop = moe_lib.moe_forward(lp["moe"], m_in, spec)
    else:
        m_out = mlp_forward(lp["mlp"], m_in, spec.mlp_type)
        aux = drop = _zero(h.device)
    return h + m_out, kv, aux, drop


def _block_decode(lp, h, cache_k, cache_v, pos: int, spec: ModelSpec,
                  is_moe: bool):
    a_in = norm(h, lp["ln1"], spec.norm_type)
    attn = mla_decode if spec.attention_type == "mla" else gqa_decode
    h = h + attn(lp["attn"], a_in, cache_k, cache_v, pos, spec)
    m_in = norm(h, lp["ln2"], spec.norm_type)
    if is_moe:
        m_out = moe_lib.moe_forward(lp["moe"], m_in, spec)[0]
    else:
        m_out = mlp_forward(lp["mlp"], m_in, spec.mlp_type)
    return h + m_out


def _stacks(spec: ModelSpec):
    """``(name, n_layers, is_moe)`` of the prefix (if any), then the body."""
    n_prefix = _n_prefix(spec)
    out = [("prefix", n_prefix, False)] if n_prefix else []
    return out + [("body", spec.num_layers - n_prefix, spec.num_experts > 0)]


def embed_tokens(params, tokens, spec: ModelSpec, patches=None):
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens]
    if spec.scale_embed:
        h = h * torch.sqrt(torch.tensor(float(spec.d_model))).to(cd)
    if patches is not None:
        # VLM: the stub image-patch embeddings go first.
        h = torch.cat([patches.to(cd), h], dim=1)
    return h


def lm_logits(params, h, spec: ModelSpec):
    cd = spec.compute_dtype
    if spec.tie_embeddings or "lm_head" not in params:
        return h @ params["embed"].to(cd).T
    return h @ params["lm_head"].to(cd)


def _split(spec: ModelSpec, seq_group, total: int):
    """This rank's :class:`~.common.SeqSplit`, or None (no sequence
    parallelism, or a model group of one)."""
    if not spec.seq_parallel or seq_group is None or seq_group.size == 1:
        return None
    return SeqSplit.of(seq_group, total)


def _forward(params, tokens, spec: ModelSpec, patches=None,
             collect_cache: bool = False, seq_group=None):
    """``(logits, kvs, {"aux", "drop"}, seq)``: ``kvs`` every layer's
    cache entries, prefix first (with ``collect_cache``, else empty);
    ``seq`` this rank's :class:`~.common.SeqSplit` under sequence
    parallelism (the logits are then the chunk's), else None."""
    _check_supported(spec)
    h = embed_tokens(params, tokens, spec, patches=patches)
    b, s = h.shape[:2]
    seq = _split(spec, seq_group, s)
    if seq is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    else:
        h = seq.narrow(h)
        positions = seq.positions(b, tokens.device)
    kvs = []
    aux_total = drop_total = _zero(h.device)
    for name, n, is_moe in _stacks(spec):
        block = _block_forward
        if spec.remat and name == "body" and torch.is_grad_enabled():
            # The reference's jax.checkpoint around the body's blocks:
            # each block's activations are recomputed in the backward.
            block = functools.partial(checkpoint, _block_forward,
                                      use_reentrant=False)
        for lp in layer_views(params[name], n):
            h, kv, aux, drop = block(lp, h, positions, spec, is_moe, seq)
            if collect_cache:
                kvs.append(kv)
            aux_total = aux_total + aux
            if name == "body":      # the reference sums the body's alone
                drop_total = drop_total + drop
    h = norm(h, params["ln_f"], spec.norm_type)
    return lm_logits(params, h, spec), kvs, {"aux": aux_total,
                                             "drop": drop_total}, seq


def forward(params, tokens, spec: ModelSpec, patches=None,
            collect_cache: bool = False):
    """Logits (B, n_img + S, V_padded) for tokens (B, S) after ``patches``
    (B, n_img, d), if any; with ``collect_cache`` ``(logits, kv)``,
    ``kv`` each layer's cache entries, prefix first."""
    logits, kvs, _, _ = _forward(params, tokens, spec, patches,
                                 collect_cache)
    return (logits, kvs) if collect_cache else logits


def loss_fn(params, batch, spec: ModelSpec, seq_group=None):
    """``(loss, metrics)`` as the reference's ``loss_fn``: the CE over
    the text positions plus ``router_aux_weight`` times the MoE layers'
    summed aux loss; ``metrics`` ``{"ce", "aux", "drop"}`` (zeros for a
    dense stack).  Under sequence parallelism (``spec.seq_parallel``
    and a ``seq_group``) ``loss`` is this rank's share, which the model
    ranks' shares sum to, and ``metrics`` holds the whole step's
    ``loss`` and ``ce`` (summed over ``seq_group``)."""
    patches = batch.get("patches")
    logits, _, aux, seq = _forward(params, batch["tokens"], spec, patches,
                                   seq_group=seq_group)
    n_img = 0 if patches is None else patches.shape[1]
    labels, mask = batch["labels"], batch.get("mask")
    if seq is None:
        logits = logits[:, n_img:]                  # only text positions
        loss = cross_entropy(logits, labels, mask)
        total = loss + spec.router_aux_weight * aux["aux"]
        return total, {"ce": loss, "aux": aux["aux"], "drop": aux["drop"]}
    # This chunk's text positions, over the dp shard's token count.
    lo = max(seq.offset, n_img)
    hi = max(seq.offset + seq.length, lo)
    count = float(labels.numel()) if mask is None \
        else torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)
    part = None if mask is None else mask[:, lo - n_img:hi - n_img]
    loss = cross_entropy(logits[:, lo - seq.offset:hi - seq.offset],
                         labels[:, lo - n_img:hi - n_img], part, count)
    # Every rank holds the whole aux loss: count it once.
    total = loss + spec.router_aux_weight * aux["aux"] * (seq.rank == 0)
    from ..core import dist as dist_mod
    summed = dist_mod.psum(torch.stack([loss, total]).detach(), seq.group)
    return total, {"ce": summed[0], "aux": aux["aux"], "drop": aux["drop"],
                   "loss": summed[1]}


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_len(spec: ModelSpec, seq: int) -> int:
    return min(seq, spec.sliding_window) if spec.sliding_window else seq


def init_cache(spec: ModelSpec, batch: int, seq: int, device=None) -> dict:
    """A zeros cache for ``batch`` rows and ``seq`` positions."""
    _check_supported(spec)
    s = cache_len(spec, seq)
    if spec.attention_type == "mla":
        k_shape = (batch, s, spec.kv_lora_rank)
        v_shape = (batch, s, spec.qk_rope_dim)
    else:
        k_shape = v_shape = (batch, s, spec.num_kv_heads,
                             spec.resolved_head_dim)
    cd = spec.compute_dtype

    def stack(n):
        return {"k": torch.zeros((n,) + k_shape, dtype=cd, device=device),
                "v": torch.zeros((n,) + v_shape, dtype=cd, device=device)}

    n_prefix = _n_prefix(spec)
    cache = {"body": stack(spec.num_layers - n_prefix),
             "pos": torch.zeros((), dtype=torch.int32)}
    if n_prefix:
        cache["prefix"] = stack(n_prefix)
    return cache


def prefill(params, tokens, spec: ModelSpec, patches=None, max_seq=None):
    """Run the prompt (after its ``patches``, if any), build the cache
    for ``max_seq`` positions (the prompt's with its patches by default),
    return ``(logits[:, -1], cache)``.  Under a sliding window the cache
    keeps the trailing window; without one a prompt longer than the
    cache raises ``ValueError``."""
    b, s = tokens.shape
    if patches is not None:
        s += patches.shape[1]
    max_seq = max_seq or s
    cl = cache_len(spec, max_seq)
    if not spec.sliding_window and s > cl:
        raise ValueError(
            f"{spec.name}: a prompt of {s} positions (image patches "
            f"included) does not fit a cache of max_seq {max_seq}: size "
            f"max_seq with the patches")
    logits, kvs, _, _ = _forward(params, tokens, spec, patches=patches,
                                 collect_cache=True)
    cache = init_cache(spec, b, max_seq, device=tokens.device)
    bufs = [(cache[name]["k"][i], cache[name]["v"][i])
            for name, n, _ in _stacks(spec) for i in range(n)]
    for (buf_k, buf_v), kv in zip(bufs, kvs):
        for buf, x in zip((buf_k, buf_v), kv):
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
    for name, n, is_moe in _stacks(spec):
        ks = cache[name]["k"].unbind(0)
        vs = cache[name]["v"].unbind(0)
        for i, lp in enumerate(layer_views(params[name], n)):
            h = _block_decode(lp, h, ks[i], vs[i], pos, spec, is_moe)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = lm_logits(params, h, spec)[:, 0]
    return logits, {**cache, "pos": torch.tensor(pos + 1,
                                                 dtype=torch.int32)}


class TransformerLM(ModelModule):
    """The model as a module: its parameters under the reference's
    names; ``forward(batch)`` returns ``(loss, metrics)``."""

    def __init__(self, spec: ModelSpec, params: dict):
        _check_supported(spec)
        super().__init__(spec, params, loss_fn)
