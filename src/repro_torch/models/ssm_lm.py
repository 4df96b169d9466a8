"""xLSTM language model (counterpart of ``repro/models/ssm_lm.py``;
xlstm-350m): mLSTM blocks with an sLSTM block every ``slstm_every``
layers (the paper's xLSTM[m:s] ratio), pre-norm residual, tied logits.

The tree keeps the reference's names: ``mlstm`` and ``slstm``, each
``{ln, mixer/*}`` stacked over its own kind's layers, ``embed`` and
``ln_f``.  The cache is recurrent state alone, ``O(1)`` in the
sequence: :func:`init_cache` ignores ``seq``; :func:`decode_step`
writes each layer's new state into it in place.
"""
from __future__ import annotations

import torch

from . import xlstm
from .common import (ModelSpec, cross_entropy, embed_init, layer_views, norm,
                     norm_params, stack_layers)

_KINDS = {"m": ("mlstm", xlstm.mlstm_params, xlstm.mlstm_forward,
                xlstm.mlstm_init_state),
          "s": ("slstm", xlstm.slstm_params, xlstm.slstm_forward,
                xlstm.slstm_init_state)}


def _layout(spec: ModelSpec):
    """The block kind of each layer: ``"s"`` every ``slstm_every``-th."""
    return ["s" if spec.slstm_every and (i + 1) % spec.slstm_every == 0
            else "m" for i in range(spec.num_layers)]


def _segments(spec: ModelSpec):
    """Runs of one block kind as ``[(kind, start, end)]`` in that kind's
    own layer index, and the two kinds' layer counts."""
    kinds = _layout(spec)
    segs, count = [], {"m": 0, "s": 0}
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        k = kinds[i]
        segs.append((k, count[k], count[k] + j - i))
        count[k] += j - i
        i = j
    return segs, count["m"], count["s"]


def init_params(gen: torch.Generator, spec: ModelSpec, device=None) -> dict:
    _, n_m, n_s = _segments(spec)
    params = {
        "embed": embed_init(gen, (spec.padded_vocab, spec.d_model), device),
        "ln_f": norm_params(spec.d_model, spec.norm_type, device),
    }
    for kind, n in (("m", n_m), ("s", n_s)):
        name, make, _, _ = _KINDS[kind]
        if n:
            params[name] = stack_layers(n, lambda: {
                "ln": norm_params(spec.d_model, spec.norm_type, device),
                "mixer": make(gen, spec, device)})
    return params


def _run(params, h, spec: ModelSpec, states=None):
    """The blocks in layer order.  Without ``states`` each layer starts
    from its initial state and its final state is returned stacked per
    kind; with ``states`` (a cache's ``{"mlstm", "slstm"}``) each layer
    continues from its entry there, which takes the new state in place."""
    segs, n_m, n_s = _segments(spec)
    counts = {"m": n_m, "s": n_s}
    layers = {k: layer_views(params[_KINDS[k][0]], counts[k])
              for k in counts if counts[k]}
    new = {"m": [], "s": []}
    for kind, a, bnd in segs:
        name, _, fwd, _ = _KINDS[kind]
        for i in range(a, bnd):
            lp = layers[kind][i]
            st = None if states is None else \
                {k: x[i] for k, x in states[name].items()}
            out, ns = fwd(lp["mixer"], norm(h, lp["ln"], spec.norm_type),
                          spec, state=st)
            h = h + out
            if st is not None:
                for k, x in ns.items():
                    st[k].copy_(x)
            else:
                new[kind].append(ns)
    if states is not None:
        return h, states
    return h, {_KINDS[k][0]: {key: torch.stack([s[key] for s in new[k]])
                              for key in new[k][0]} if new[k] else None
               for k in new}


def forward(params, tokens, spec: ModelSpec):
    """``(logits (B, S, V_padded), states)``."""
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens]
    h, states = _run(params, h, spec)
    h = norm(h, params["ln_f"], spec.norm_type)
    return h @ params["embed"].to(cd).T, states


def loss_fn(params, batch, spec: ModelSpec):
    logits, _ = forward(params, batch["tokens"], spec)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss}


def init_cache(spec: ModelSpec, batch: int, seq: int, device=None) -> dict:
    """Recurrent state only: ``seq`` is ignored."""
    _, n_m, n_s = _segments(spec)
    cache = {"pos": torch.zeros((), dtype=torch.int32)}
    for kind, n in (("m", n_m), ("s", n_s)):
        name, _, _, init = _KINDS[kind]
        cache[name] = {k: torch.stack([x] * n)
                       for k, x in init(spec, batch, device).items()} \
            if n else None
    return cache


def prefill(params, tokens, spec: ModelSpec, max_seq=None):
    logits, states = forward(params, tokens, spec)
    cache = {"pos": torch.tensor(tokens.shape[1], dtype=torch.int32),
             **states}
    # a copy: a view would keep the (B, S, V) logits alive
    return logits[:, -1].clone(), cache


def decode_step(params, cache, tokens, spec: ModelSpec):
    """One decode step.  tokens (B, 1).  Returns ``(logits (B, V),
    cache)``: the same state buffers, written in place, and ``pos`` one
    further."""
    cd = spec.compute_dtype
    h = params["embed"].to(cd)[tokens]
    h, _ = _run(params, h, spec, states=cache)
    h = norm(h, params["ln_f"], spec.norm_type)
    logits = (h @ params["embed"].to(cd).T)[:, 0]
    return logits, {**cache, "pos": torch.tensor(int(cache["pos"]) + 1,
                                                 dtype=torch.int32)}
