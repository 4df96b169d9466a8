"""Optimizers: SGD-momentum and AdamW (counterpart of
``repro/optim/optimizers.py``).

The reference returns updates that the step adds to the parameters; in
PyTorch's idiom ``update(grads, state, params)`` writes the new
parameters in place (under ``no_grad``) and returns the new state.  The
value is the same: ``p + (-lr·u)`` and ``p - lr·u`` round identically.

``adamw`` runs the one-pass kernel K5 (``kernels/fused_adamw.py``) over
each parameter leaf, updating ``p``, ``m`` and ``v`` in place; it
computes the reference's ``adamw`` (``1-b2`` multiplies ``g`` before the
second ``g``, as in ``kernels/ref.py``, so the two differ by rounding).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import tree as tree_mod
from ..kernels import fused_adamw


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params) -> state


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _zeros(params):
    return tree_mod.tree_map(lambda p: torch.zeros_like(
        p, memory_format=torch.contiguous_format).detach(), params)


def sgd(lr, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mom": _zeros(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        step_lr = float(lr_fn(count))
        for p, g, m in zip(tree_mod.leaves(params), tree_mod.leaves(grads),
                           tree_mod.leaves(state["mom"])):
            m.mul_(momentum).add_(g.to(m.dtype))
            p.add_((-step_lr * (m + weight_decay * p)).to(p.dtype))
        return {"mom": state["mom"], "count": count}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        step_lr = float(lr_fn(count))
        for p, g, m, v in zip(tree_mod.leaves(params),
                              tree_mod.leaves(grads),
                              tree_mod.leaves(state["m"]),
                              tree_mod.leaves(state["v"])):
            fused_adamw.adamw_update(
                p.data, g.contiguous(), m, v, lr=step_lr, b1=b1, b2=b2,
                eps=eps, weight_decay=weight_decay, count=count,
                inplace=True)
        return {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer(init, update)
