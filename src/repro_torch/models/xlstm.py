"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``;
arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar memory with
a block-diagonal recurrence).

Both use exponential gating with the max-state stabilizer ``m_t``.  The
sequential forms walk the sequence in a Python loop (the reference's
``lax.scan``); decode is the same step on one token, carrying ``(C, n,
m)`` / ``(c, n, m, h)``.  :func:`mlstm_forward` takes the chunkwise
form when ``spec.mlstm_chunk`` divides the sequence and is shorter than
it, the reference's rule.  All of it is plain torch, as the reference
computes it outside any kernel.

Maxima go through ``torch.amax``, whose gradient splits evenly among
ties as ``jnp.max``'s does (``torch.max(dim=)`` would send it all to
one index).  The reference pins the chunked form's inputs replicated
with a GSPMD constraint (``pin``); the port never shards a mixer's
internals, so there is nothing to pin.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import ModelSpec, dense_init


def _heads(spec: ModelSpec):
    h = spec.num_heads
    return h, spec.d_model // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_params(gen, spec: ModelSpec, device=None) -> dict:
    d = spec.d_model
    h, _ = _heads(spec)
    up = 2 * d
    return {
        "up_proj": dense_init(gen, (d, up), device=device),
        "wq": dense_init(gen, (up, d), device=device),
        "wk": dense_init(gen, (up, d), device=device),
        "wv": dense_init(gen, (up, d), device=device),
        "wi": dense_init(gen, (up, h), device=device),
        "wf": dense_init(gen, (up, h), device=device),
        "wo_gate": dense_init(gen, (up, d), device=device),
        "down_proj": dense_init(gen, (d, d), device=device),
        "f_bias": torch.full((h,), 3.0, dtype=torch.float32, device=device),
    }


def _mlstm_scan(q, k, v, i_pre, f_pre, state):
    """The sequential recurrence.  q, k, v (B,H,S,dh); i_pre, f_pre
    (B,H,S); ``state`` ``(C (B,H,dh,dh), n (B,H,dh), m (B,H))``.
    Returns ``(y (B,H,S,dh), state)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    c, n, m = state
    ys = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t] * scale, v[:, :, t]
        it, ft = i_pre[:, :, t], f_pre[:, :, t]
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g[..., None, None] * c \
            + i_g[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = f_g[..., None] * n + i_g[..., None] * kt
        num = (qt[..., None, :] @ c)[..., 0, :]
        den = torch.abs(torch.sum(qt * n, dim=-1))
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(ys, dim=2), (c, n, m)


def _mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk: int):
    """The chunkwise-parallel mLSTM (Mamba2's SSD algebra): a masked
    quadratic form inside each chunk, ``(C, n, m)`` carried across chunk
    boundaries.  Shapes as :func:`_mlstm_scan`'s.  It matches the
    sequential scan wherever the ``exp(-m)`` clamp of the denominator
    does not bind."""
    b, h, s, dh = q.shape
    k = k * (1.0 / math.sqrt(dh))
    mask = torch.from_numpy(np.tril(np.ones((chunk, chunk), bool))) \
        .to(q.device)
    c_in, n_in, m_in = state
    ys = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]    # (B,H,L,dh)
        ic = i_pre[:, :, sl]                                   # (B,H,L)
        bcum = torch.cumsum(F.logsigmoid(f_pre[:, :, sl]), dim=2)
        total = bcum[..., -1]                                  # (B,H)

        # per-position stabilizer
        intra = bcum[..., :, None] - bcum[..., None, :] \
            + ic[..., None, :]                                 # (B,H,t,s)
        intra = torch.where(mask, intra, -torch.inf)
        m_intra = torch.amax(intra, dim=-1)                    # (B,H,L)
        m_t = torch.maximum(m_in[..., None] + bcum, m_intra)

        # intra-chunk attention-like term
        w = torch.exp(intra - m_t[..., None])                  # (B,H,t,s)
        sc = (qc @ kc.transpose(-1, -2)) * w
        num_intra = sc @ vc
        den_intra = w @ kc

        # inter-chunk term from the carried state
        g = torch.exp(m_in[..., None] + bcum - m_t)            # (B,H,L)
        num_inter = (qc @ c_in) * g[..., None]
        den_inter = (qc @ n_in[..., None])[..., 0] * g
        den_q = torch.sum(qc * den_intra, dim=-1)
        den = torch.abs(den_q + den_inter)
        ys.append((num_intra + num_inter)
                  / torch.maximum(den, torch.exp(-m_t))[..., None])

        # chunk-end state update: (wk·k)ᵀ v, a product over (b, h)
        tail = total[..., None] - bcum + ic                    # (B,H,L)
        m_out = torch.maximum(m_in + total, torch.amax(tail, dim=-1))
        wkk = torch.exp(tail - m_out[..., None])[..., None] * kc
        carry = torch.exp(m_in + total - m_out)
        c_in = c_in * carry[..., None, None] + wkk.transpose(-1, -2) @ vc
        n_in = n_in * carry[..., None] + wkk.sum(dim=2)
        m_in = m_out
    return torch.cat(ys, dim=2), (c_in, n_in, m_in)


def mlstm_init_state(spec: ModelSpec, batch: int, device=None) -> dict:
    h, dh = _heads(spec)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), -1e30, **f32)}


def mlstm_forward(params, x, spec: ModelSpec, state=None):
    """x (B,S,d) -> ``(out (B,S,d), {"c", "n", "m"})`` from ``state``
    (zeros and ``m = -1e30`` when None)."""
    b, s, d = x.shape
    h, dh = _heads(spec)
    cd = spec.compute_dtype
    up = x @ params["up_proj"].to(cd)

    def heads(w):                                  # (B,H,S,dh) in f32
        return (up @ w.to(cd)).reshape(b, s, h, dh).to(torch.float32) \
            .transpose(1, 2)

    q, k, v = heads(params["wq"]), heads(params["wk"]), heads(params["wv"])
    i_pre = (up @ params["wi"].to(cd)).to(torch.float32).transpose(1, 2)
    f_pre = ((up @ params["wf"].to(cd)).to(torch.float32)
             + params["f_bias"]).transpose(1, 2)
    if state is None:
        state = mlstm_init_state(spec, b, x.device)
    carry = (state["c"], state["n"], state["m"])
    chunk = spec.mlstm_chunk
    if chunk and s % chunk == 0 and s > chunk:
        y, (c, n, m) = _mlstm_chunked(q, k, v, i_pre, f_pre, carry, chunk)
    else:
        y, (c, n, m) = _mlstm_scan(q, k, v, i_pre, f_pre, carry)
    o = torch.sigmoid((up @ params["wo_gate"].to(cd)).to(torch.float32))
    y = (y.transpose(1, 2).reshape(b, s, d) * o).to(cd)
    return y @ params["down_proj"].to(cd), {"c": c, "n": n, "m": m}


def mlstm_decode(params, x, state, spec: ModelSpec):
    return mlstm_forward(params, x, spec, state=state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(gen, spec: ModelSpec, device=None) -> dict:
    d = spec.d_model
    h, dh = _heads(spec)
    return {
        "w_in": dense_init(gen, (d, 4 * d), device=device),  # z,i,f,o
        "r_rec": torch.randn((h, dh, 4 * dh), generator=gen, device=device)
        / math.sqrt(dh),                                    # block-diagonal
        "bias": torch.cat([torch.zeros((2 * d,), device=device),
                           torch.full((d,), 3.0, device=device),
                           torch.zeros((d,), device=device)]),
        "down_proj": dense_init(gen, (d, d), device=device),
    }


def slstm_init_state(spec: ModelSpec, batch: int, device=None) -> dict:
    h, dh = _heads(spec)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh), **f32),
            "n": torch.ones((batch, h, dh), **f32),
            "m": torch.zeros((batch, h), **f32),
            "h": torch.zeros((batch, h, dh), **f32)}


def slstm_forward(params, x, spec: ModelSpec, state=None):
    """x (B,S,d) -> ``(out (B,S,d), {"c", "n", "m", "h"})``; the time
    loop is sequential, as in the reference."""
    b, s, d = x.shape
    h, dh = _heads(spec)
    cd = spec.compute_dtype
    pre = (x @ params["w_in"].to(cd)).to(torch.float32) + params["bias"]
    pre = pre.reshape(b, s, 4, h, dh)
    if state is None:
        state = slstm_init_state(spec, b, x.device)
    r_rec = params["r_rec"]
    c, n, m, hprev = state["c"], state["n"], state["m"], state["h"]
    ys = []
    for t in range(s):
        # (H,B,dh) @ (H,dh,4dh): the block-diagonal recurrence per head
        rec = (hprev.transpose(0, 1) @ r_rec).transpose(0, 1) \
            .reshape(b, h, 4, dh).transpose(1, 2)           # (B,4,H,dh)
        gates = pre[:, t] + rec
        zp, ip, fp, op = gates.unbind(1)
        z = torch.tanh(zp)
        o = torch.sigmoid(op)
        logf = F.logsigmoid(fp)
        m_h = torch.amax(ip, dim=-1)                        # per head
        m_new = torch.maximum(torch.mean(logf, dim=-1) + m, m_h)
        i_g = torch.exp(ip - m_new[..., None])
        f_g = torch.exp(logf + (m - m_new)[..., None])
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        hprev = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(cd)
    out = y @ params["down_proj"].to(cd)
    return out, {"c": c, "n": n, "m": m, "h": hprev}


def slstm_decode(params, x, state, spec: ModelSpec):
    return slstm_forward(params, x, spec, state=state)
