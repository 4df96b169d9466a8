"""Mixture-of-Experts layer: top-k router + sort-based expert dispatch
(counterpart of ``repro/models/moe.py``).

Tokens are split into groups of about ``moe_group_size`` (the
reference's group dim, here a leading batch dim in place of ``vmap``).
Within a group the token→expert assignments are sorted, each token is
copied into a dense ``(E, C, d)`` buffer at its expert's next free slot
(capacity ``C``; overflow goes to a discarded row, GShard's drop), all
experts run as one batched product, and the results come back weighted
by the renormalised router probabilities.  The reference computes all of
it outside any kernel, so the port is plain torch.

Two choices keep the port's routing and sums those of the reference:

* top-k takes the first ``k`` of a stable descending sort, so among
  exactly tied probabilities the lower expert index wins, as in
  ``lax.top_k`` (bf16 router logits tie often);
* the combine inverts the sort (a gather) and sums each token's ``k``
  contributions in slot order, where the reference scatter-adds: an
  ``index_add_`` on CUDA would sum in atomic order and change bits from
  call to call.

The router's aux loss is the switch-style load-balance loss over the
global batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelSpec, dense_init
from .mlp import mlp_forward, mlp_params


def moe_params(gen, spec: ModelSpec, device=None) -> dict:
    d, e, f = spec.d_model, spec.num_experts, spec.moe_d_ff
    p = {
        "router": dense_init(gen, (d, e), device=device),
        "w1": dense_init(gen, (e, d, f), device=device),
        "w_gate": dense_init(gen, (e, d, f), device=device),
        "w2": dense_init(gen, (e, f, d), device=device),
    }
    if spec.num_shared_experts:
        p["shared"] = mlp_params(gen, d,
                                 spec.moe_d_ff * spec.num_shared_experts,
                                 spec.mlp_type, device)
    return p


def _capacity(tokens: int, spec: ModelSpec) -> int:
    cap = int(tokens * spec.top_k / spec.num_experts * spec.capacity_factor)
    return max(8, min(tokens, cap))


def _groups(t: int, spec: ModelSpec) -> int:
    """The reference's group count: ``t // moe_group_size``, lowered
    until it divides ``t``."""
    n = max(1, t // spec.moe_group_size)
    while t % n:
        n -= 1
    return n


def top_k(probs: torch.Tensor, k: int):
    """``(weights, indices)`` of the ``k`` largest along the last dim,
    the lower index first among ties (``lax.top_k``'s order)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _dispatch(xg, pg, spec: ModelSpec, params, c: int):
    """Sort-based dispatch of every group at once.  ``xg`` (G, Tg, d),
    ``pg`` (G, Tg, E).  Returns ``(y (G, Tg, d), top_i (G, Tg, k),
    n_valid)``."""
    cd = xg.dtype
    e, k = spec.num_experts, spec.top_k
    g, t, d = xg.shape
    top_w, top_i = top_k(pg, k)                                # (G, Tg, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    flat_e = top_i.reshape(g, t * k)
    sorted_e, sort_idx = torch.sort(flat_e, dim=-1, stable=True)
    first_of_e = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * k, device=xg.device) - first_of_e
    valid = rank < c
    dest = torch.where(valid, sorted_e * c + rank, e * c)      # overflow
    token_of = sort_idx // k

    # Each group's buffer has E*C + 1 rows, the last taking every
    # overflow write (discarded); the groups lie one after another.
    rows = e * c + 1
    offs = torch.arange(g, device=xg.device)[:, None]
    src = xg.reshape(g * t, d)[(token_of + offs * t).reshape(-1)]
    buf = torch.zeros((g * rows, d), dtype=cd, device=xg.device) \
        .index_copy(0, (dest + offs * rows).reshape(-1), src)
    # All experts at once: (E, G*C, d) against (E, d, f).  Each buffer
    # is dropped once used: at deepseek-v2-lite's capacity the (E, C, d)
    # and (E, C, f) tensors are 0.5-1.6 GB apiece.
    xe = buf.view(g, rows, d)[:, :e * c].reshape(g, e, c, d) \
        .transpose(0, 1).reshape(e, g * c, d)
    del buf, src
    h = torch.bmm(xe, params["w1"].to(cd))
    gate = torch.bmm(xe, params["w_gate"].to(cd))
    del xe
    h = F.silu(gate) * h
    del gate
    ye = torch.bmm(h, params["w2"].to(cd))                    # (E, G*C, d)
    del h
    ybuf = torch.cat([ye.view(e, g, c, d).transpose(0, 1).reshape(
        g, e * c, d), torch.zeros((g, 1, d), dtype=cd, device=xg.device)],
        dim=1)
    del ye
    y_sorted = ybuf.gather(1, dest[..., None].expand(g, t * k, d))
    del ybuf
    w_sorted = (top_w.reshape(g, t * k).gather(1, sort_idx) * valid).to(cd)
    contrib = y_sorted * w_sorted[..., None]
    del y_sorted
    # Back to (token, slot) order through the inverse permutation, then
    # each token's k contributions summed: no scatter-add.
    inv = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.arange(t * k, device=xg.device).expand(g, t * k))
    y = contrib.gather(1, inv[..., None].expand(g, t * k, d)) \
        .view(g, t, k, d).sum(2)
    return y, top_i, valid.sum()


def moe_forward(params, x, spec: ModelSpec):
    """x: (B, S, d) -> ``(out, aux_loss, drop_frac)``."""
    b, s, d = x.shape
    e, k = spec.num_experts, spec.top_k
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    n_groups = _groups(t, spec)
    tg = t // n_groups
    c = _capacity(tg, spec)

    logits = (xt @ params["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    y, top_i, n_valid = _dispatch(xt.view(n_groups, tg, d),
                                  probs.view(n_groups, tg, e), spec, params,
                                  c)
    y = y.reshape(t, d)

    if spec.num_shared_experts:
        y = y + mlp_forward(params["shared"], xt, spec.mlp_type)

    # switch load-balance loss over the GLOBAL batch
    counts = torch.bincount(top_i.reshape(-1), minlength=e) \
        .to(torch.float32)
    frac = counts / (t * k)
    importance = probs.mean(0)
    aux = e * torch.sum(frac * importance)
    drop_frac = 1.0 - n_valid.to(torch.float32) / (t * k)
    return y.reshape(b, s, d), aux, drop_frac
