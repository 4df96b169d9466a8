"""Mamba2 (SSD) block (counterpart of ``repro/models/mamba2.py``): the
chunked parallel scan for training and prefill, and the one-token
recurrence for decode.

The input projections give ``(z, x, B, C, dt)``; a depthwise causal conv
of width ``conv_width`` runs over ``(x, B, C)``; each head decays by
``exp(-exp(A_log)·dt)``; the state is ``(heads, d_state, head_dim)`` per
sequence.  The reference computes all of it outside any kernel, and so
does the port, in plain torch with f32 statistics (its
``_gated_norm`` is a silu-gated RMSNorm that does not go through K6).

The reference's four-operand einsums are written here as explicit
batched products over ``(batch, head)``, so that no ``(B, q, s, H, P)``
tensor is ever formed (1 GiB per sequence per chunk at zamba2's width):
the intra-chunk weights ``C·Bᵀ · decay`` (B, q, s, H) are formed once
and multiply ``dt·x``.  The intra-chunk terms of every chunk are
computed at once; only the state passes from chunk to chunk in a loop.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import ModelSpec, dense_init


def mamba2_dims(spec: ModelSpec):
    d_inner = spec.ssm_expand * spec.d_model
    heads = spec.ssm_heads or d_inner // spec.ssm_head_dim
    p = d_inner // heads
    return d_inner, heads, p, spec.ssm_state


def mamba2_params(gen, spec: ModelSpec, device=None) -> dict:
    d = spec.d_model
    d_inner, h, p, n = mamba2_dims(spec)
    conv_ch = d_inner + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "z_proj": dense_init(gen, (d, d_inner), device=device),
        "xbc_proj": dense_init(gen, (d, conv_ch), device=device),
        "dt_proj": dense_init(gen, (d, h), device=device),
        "conv_w": torch.randn((spec.conv_width, conv_ch), generator=gen,
                              device=device) * 0.1,
        "conv_b": torch.zeros((conv_ch,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm_scale": torch.zeros((d_inner,), **f32),
        "out_proj": dense_init(gen, (d_inner, d), device=device),
    }


def _project(params, x, cd):
    z = x @ params["z_proj"].to(cd)
    xbc = x @ params["xbc_proj"].to(cd)
    dt = x @ params["dt_proj"].to(cd)
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along the sequence: the taps ``i = 0..w-1``
    summed in f32 in that order, as the reference's shifted adds."""
    width = w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + s].to(torch.float32) * w[i]
    return F.silu(out + b).to(xbc.dtype)


def _gated_norm(y, z, scale, eps: float = 1e-6):
    y = (y * F.silu(z.to(torch.float32))).to(torch.float32)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return y * (1.0 + scale)


def _split_xbc(xbc, d_inner: int, n: int):
    """``(x, B, C)`` in f32 from the conv's output ``(..., ch)``."""
    return (xbc[..., :d_inner].to(torch.float32),
            xbc[..., d_inner:d_inner + n].to(torch.float32),
            xbc[..., d_inner + n:].to(torch.float32))


def _ssd(xs, bmat, cmat, dt, log_decay, q: int, h0):
    """The SSD scan over chunks of ``q``.  xs (B,S,H,P); bmat, cmat
    (B,S,N); dt, log_decay (B,S,H); h0 (B,H,N,P).  Returns ``(y
    (B,S,H,P), h_final)``."""
    bsz, s, h, p = xs.shape
    n = bmat.shape[-1]
    nc = s // q
    # chunk-major rows: (B·nc, q, ...)
    xq = xs.reshape(bsz * nc, q, h, p)
    bq = bmat.reshape(bsz * nc, q, n)
    cq = cmat.reshape(bsz * nc, q, n)
    dtq = dt.reshape(bsz * nc, q, h)
    l = torch.cumsum(log_decay.reshape(bsz * nc, q, h), dim=1)  # inclusive
    mask = torch.from_numpy(np.tril(np.ones((q, q), bool))).to(xs.device)

    # intra-chunk quadratic form; mask BEFORE exp: for t < s the exponent
    # is positive and would overflow to inf (inf · 0 = NaN after masking).
    ldiff = l[:, :, None, :] - l[:, None, :, :]                 # (R,q,s,H)
    dec = torch.exp(torch.where(mask[None, :, :, None], ldiff, -1e30))
    cb = cq @ bq.transpose(1, 2)                                 # (R,q,s)
    wts = (cb[..., None] * dec).permute(0, 3, 1, 2)              # (R,H,q,s)
    dtx = (dtq[..., None] * xq).permute(0, 2, 1, 3)              # (R,H,s,P)
    y = (wts @ dtx).permute(0, 2, 1, 3)                          # (R,q,H,P)

    # the state at each chunk's end from its own inputs: (R,H,N,P)
    l_last = l[:, -1:, :]
    wx = ((dtq * torch.exp(l_last - l))[..., None] * xq).permute(0, 2, 1, 3)
    dh = bq.transpose(1, 2)[:, None] @ wx
    decay = torch.exp(l_last[:, 0, :])[..., None, None]          # (R,H,1,1)
    dh = dh.reshape(bsz, nc, h, n, p)
    decay = decay.reshape(bsz, nc, h, 1, 1)

    # the state entering each chunk, carried in turn
    starts = []
    hstate = h0
    for c in range(nc):
        starts.append(hstate)
        hstate = dh[:, c] + decay[:, c] * hstate
    hin = torch.stack(starts, dim=1).reshape(bsz * nc, h, n, p)

    # inter-chunk contribution from the carried state
    y_inter = (cq[:, None] @ hin) * torch.exp(l).permute(0, 2, 1)[..., None]
    y = y + y_inter.permute(0, 2, 1, 3)
    return y.reshape(bsz, s, h, p), hstate


def mamba2_forward(params, x, spec: ModelSpec, h0=None):
    """Full-sequence SSD.  x (B,S,d) -> ``(out (B,S,d), state)``, where
    ``state = {"ssm": (B,H,N,P) f32, "conv": (B,w-1,ch)}`` lets
    :func:`mamba2_decode` continue from position S.  ``S`` must be a
    multiple of ``spec.ssm_chunk`` or shorter than it."""
    bsz, s, _ = x.shape
    d_inner, h, p, n = mamba2_dims(spec)
    cd = spec.compute_dtype
    q = spec.ssm_chunk
    if not (s % q == 0 or s < q):
        raise ValueError(f"{spec.name}: seq {s} is neither a multiple of "
                         f"ssm_chunk {q} nor shorter than it")
    q = min(q, s)

    z, xbc_raw, dt_raw = _project(params, x, cd)
    w = spec.conv_width
    if s >= w - 1:
        conv_tail = xbc_raw[:, s - (w - 1):]
    else:
        conv_tail = F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, bmat, cmat = _split_xbc(xbc, d_inner, n)
    xs = xs.reshape(bsz, s, h, p)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])                     # (h,) negative
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
    y, h_final = _ssd(xs, bmat, cmat, dt, a * dt, q, h0)
    y = y + params["d_skip"][None, None, :, None] * xs
    y = _gated_norm(y.reshape(bsz, s, d_inner), z, params["norm_scale"])
    out = y.to(cd) @ params["out_proj"].to(cd)
    return out, {"ssm": h_final, "conv": conv_tail}


def mamba2_init_state(spec: ModelSpec, batch: int, device=None) -> dict:
    d_inner, h, p, n = mamba2_dims(spec)
    conv_ch = d_inner + 2 * n
    return {
        "ssm": torch.zeros((batch, h, n, p), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, conv_ch),
                            dtype=spec.compute_dtype, device=device),
    }


def mamba2_decode(params, x, state, spec: ModelSpec):
    """One-token recurrence.  x (B,1,d); ``state`` as
    :func:`mamba2_init_state`'s, whose conv window and SSM state are
    written in place (the port's form of the reference's donated cache).
    Returns ``(out (B,1,d), state)``."""
    bsz = x.shape[0]
    d_inner, h, p, n = mamba2_dims(spec)
    cd = spec.compute_dtype
    z, xbc, dt_raw = _project(params, x, cd)

    # conv over the cached window and the current input
    win = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv_out = (win.to(torch.float32) * params["conv_w"]).sum(1) \
        + params["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :].to(cd)
    state["conv"].copy_(win[:, 1:])

    xs, bmat, cmat = _split_xbc(xbc1[:, 0], d_inner, n)
    xs = xs.reshape(bsz, h, p)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + params["dt_bias"])
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)          # (B,H)

    hs = state["ssm"] * decay[:, :, None, None] \
        + dt[:, :, None, None] * bmat[:, None, :, None] * xs[:, :, None, :]
    state["ssm"].copy_(hs)
    y = (cmat[:, None, None, :] @ hs)[:, :, 0] \
        + params["d_skip"][None, :, None] * xs                   # (B,H,P)
    y = _gated_norm(y.reshape(bsz, 1, d_inner), z, params["norm_scale"])
    out = y.to(cd) @ params["out_proj"].to(cd)
    return out, state
