"""The data-parallel train step — where the paper's technique plugs in.

Counterpart of ``repro/train/step.py`` (its data-parallel path):

    loss.backward()                  # this rank's shard of the batch
    GradientAggregator(grads)        # ← the technique: fused buckets,
                                     #   explicit RHD/ring hops, codecs
                                     #   (overlap=True: each bucket inside
                                     #   the backward, overlap_params)
    clip_by_global_norm              # on AGGREGATED grads (global norm)
    optimizer.update                 # K5 AdamW, parameters in place

Each rank holds a full replica.  Each dp axis (``("data",)``, or
``("pod", "data")`` outermost first) is a process group
(``core/dist.py``, ``launch/mesh.py``); the gradient sum over ranks
happens only through the aggregator's explicit algorithm.  Metrics are
means over the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from .. import tree as tree_mod
from ..core import AggregatorConfig, GradientAggregator
from ..core import dist as dist_mod
from ..kernels.backend import resolve_device
from ..models import ModelApi, param_groups
from ..optim import Optimizer, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    aggregator: AggregatorConfig = AggregatorConfig()
    clip_norm: float = 1.0
    dp_axes: tuple = ("data",)


def shard_batch(batch: dict, groups: "Sequence[dist_mod.Group]") -> dict:
    """This rank's rows of a GLOBAL batch: the leading dim split evenly
    over the flattened dp ranks.  ``groups``: the dp axes' groups,
    outermost first, whose ranks flatten major to minor (pod · d +
    data), as the reference's batch spec ``P(("pod", "data"))`` splits
    it."""
    index, size = 0, 1
    for g in groups:
        index, size = index * g.size + g.rank, size * g.size
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % size:
            raise ValueError(f"batch[{k!r}] has {n} rows for {size} ranks")
        per = n // size
        out[k] = v[index * per:(index + 1) * per]
    return out


def make_train_step(model: ModelApi, optimizer: Optimizer,
                    cfg: TrainStepConfig, device=None,
                    groups: "Mapping[str, dist_mod.Group] | None" = None):
    """Build the train step for this rank.

    ``groups`` maps each of ``cfg.dp_axes`` to its process group
    (``launch.mesh.make_groups`` for ``("pod", "data")``); one dp axis
    defaults to the world group (a single rank without
    ``torch.distributed``).  ``device``: where the parameters live;
    ``None`` is CUDA (raises without a card).  Returns ``(step_fn,
    extras)`` with ``step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is the model's parameter tree
    (updated in place), ``batch`` the GLOBAL batch, and
    ``extras["aggregator"]`` the aggregator (its ``last_schedule`` is
    the executed plan)."""
    device = resolve_device(device)
    dp_axes = tuple(cfg.dp_axes)
    if groups is None:
        if len(dp_axes) != 1:
            raise ValueError(f"dp axes {dp_axes} need their groups "
                             f"(launch.mesh.make_groups)")
        groups = {dp_axes[0]: dist_mod.Group(name=dp_axes[0])}
    agg = GradientAggregator(cfg.aggregator, dp_axes, groups)
    shard_groups = [agg.groups[ax] for ax in dp_axes]

    def step_fn(params, opt_state, batch):
        local = {k: v.to(device) for k, v in
                 shard_batch(batch, shard_groups).items()}
        leaves = tree_mod.leaves(params)
        for p in leaves:
            p.grad = None
        groups = param_groups(params)
        if cfg.aggregator.overlap:
            # In-backward aggregation: each bucket is reduced on the
            # aggregator's channel as its gradients complete; backward
            # returns once they are all reduced.
            run = agg.overlap_params(params, groups=groups)
            loss, metrics = model.loss(params, local)
            grads = run.backward(loss)                  # ← the technique
        else:
            loss, metrics = model.loss(params, local)
            loss.backward()
            # A leaf with no gradient reduces as zeros (JAX's cotangent).
            grads = tree_mod.unflatten(params, [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in leaves])
            grads = agg(grads, groups=groups)          # ← the technique
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        opt_state = optimizer.update(grads, opt_state, params)
        for p in leaves:
            p.grad = None
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm}
        names = sorted(metrics)
        means = agg.mean_scalar(torch.stack(
            [metrics[k].detach().to(torch.float32) for k in names]))
        return params, opt_state, dict(zip(names, means.unbind(0)))

    return step_fn, {"aggregator": agg}
