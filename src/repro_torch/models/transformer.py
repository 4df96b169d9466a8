"""Decoder-only transformer LM, dense GQA (counterpart of the dense path
of ``repro/models/transformer.py``).

Parameters keep the reference's nested-dict names, float32 dtype and
stacked-layer leading dim (``body/*`` has shape ``(L, ...)``), so the
reference's parameter tree loads unchanged (``convert.py``) and gradient
leaves flatten into the same fusion buckets.  The reference scans the
layer stack; here a Python loop walks ``unbind`` views of it, whose
backward writes each stacked gradient once.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import tree as tree_mod
from .attention import gqa_forward, gqa_params
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
    layers = [_layer_params(gen, spec, device)
              for _ in range(spec.num_layers)]
    params = {
        "embed": embed_init(gen, (spec.padded_vocab, spec.d_model), device),
        "body": tree_mod.tree_map(lambda *xs: torch.stack(xs), *layers),
        "ln_f": norm_params(spec.d_model, spec.norm_type, device),
    }
    if not spec.tie_embeddings:
        params["lm_head"] = embed_init(gen, (spec.d_model,
                                             spec.padded_vocab), device)
    return params


def _block_forward(lp, h, positions, spec: ModelSpec):
    a_in = norm(h, lp["ln1"], spec.norm_type)
    a_out, _ = gqa_forward(lp["attn"], a_in, positions, spec)
    h = h + a_out
    m_in = norm(h, lp["ln2"], spec.norm_type)
    return h + mlp_forward(lp["mlp"], m_in, spec.mlp_type)


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


def forward(params, tokens, spec: ModelSpec):
    """Logits (B, S, V_padded) for tokens (B, S)."""
    _check_supported(spec)
    b = tokens.shape[0]
    h = embed_tokens(params, tokens, spec)
    s = h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    layers = tree_mod.tree_map(lambda w: w.unbind(0), params["body"])
    for i in range(spec.num_layers):
        lp = tree_mod.tree_map(lambda ws: ws[i], layers)
        h = _block_forward(lp, h, positions, spec)
    h = norm(h, params["ln_f"], spec.norm_type)
    return lm_logits(params, h, spec)


def loss_fn(params, batch, spec: ModelSpec):
    """``(loss, metrics)`` as the reference's ``loss_fn`` (dense: no
    router aux loss, so ``aux`` and ``drop`` are zero)."""
    logits = forward(params, batch["tokens"], spec)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    total = loss + spec.router_aux_weight * zero
    return total, {"ce": loss, "aux": zero, "drop": zero}


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
