"""Feed-forward layers (counterpart of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from .common import dense_init


def mlp_params(gen, d_model: int, d_ff: int, mlp_type: str,
               device=None) -> dict:
    if mlp_type not in ("swiglu", "geglu", "gelu"):
        raise ValueError(f"unknown mlp type {mlp_type!r}")
    p = {"w1": dense_init(gen, (d_model, d_ff), device=device)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d_model, d_ff), device=device)
    p["w2"] = dense_init(gen, (d_ff, d_model), device=device)
    return p


def mlp_forward(params, x, mlp_type: str):
    cd = x.dtype
    h = x @ params["w1"].to(cd)
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"].to(cd)) * h
    elif mlp_type == "geglu":
        h = F.gelu(x @ params["w_gate"].to(cd), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["w2"].to(cd)
