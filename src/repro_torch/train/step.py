"""The data-parallel train step — where the paper's technique plugs in.

Counterpart of ``repro/train/step.py`` (its data-parallel path):

    loss.backward()                  # this rank's shard of the batch
    GradientAggregator(grads)        # ← the technique: fused buckets,
                                     #   explicit RHD/ring hops, codecs
                                     #   (overlap=True: each bucket inside
                                     #   the backward, overlap_params)
    clip_by_global_norm              # on AGGREGATED grads (global norm)
    optimizer.update                 # K5 AdamW, parameters in place

Each dp axis (``("data",)``, or ``("pod", "data")`` outermost first) is
a process group (``core/dist.py``, ``launch/mesh.py``); the gradient sum
over ranks happens only through the aggregator's explicit algorithm.
Metrics are means over the dp ranks.

Without a model axis each rank holds a full replica.  With one
(``groups["model"]``, the reference's full-manual path,
``core/manual.py``) each rank holds its shards of the model-sharded
leaves: the loss sees ``gather_params(params)``, whose backward hands
shard-shaped gradients back; the batch is split over the dp groups
only (the model ranks of one dp index take the same rows); the
aggregator reduces over the dp axes with the model bracket on
replicated buckets; the clip sums the sharded leaves' squares over the
model group; and K5 AdamW updates the shards.

With ``seq_parallel`` on a model axis (``model.seq_parallel``) each
model rank runs the loss on its chunk of the sequence
(``models/transformer.py``), given the sequence group as
``model.loss(params, batch, seq_group=)``, and the gather boundary sums
the model ranks' gradients (``core/manual.py``).  Those collectives run
inside the backward, on the main thread, on a process group of their
own over the model ranks (``manual.own_group``, made when the step is
built), so that with ``overlap=True`` they never share one with the
overlap channel's ``ag@model`` hops.  With ``overlap=True`` the
bucket hooks sit on the shard leaves, inside the gather boundary, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from .. import telemetry
from .. import tree as tree_mod
from ..core import AggregatorConfig, GradientAggregator
from ..core import dist as dist_mod
from ..core import manual as manual_mod
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


def _seq_channel(group, spec, batch: dict, device):
    """``group`` ready for the sequence chunks of ``batch``'s rows: on
    ``cuda_ipc`` a channel whose slots hold the widest chunk a layer
    gathers or reduce-scatters in float32 (the residual stream, the kv
    heads, MLA's latent)."""
    if group.transport != "cuda_ipc":
        return group
    rows, seq = batch["tokens"].shape
    if "patches" in batch:
        seq += batch["patches"].shape[1]
    width = max(spec.d_model, spec.num_kv_heads * spec.resolved_head_dim,
                spec.kv_lora_rank + spec.qk_rope_dim)
    chunk = -(-seq // group.size)
    return dist_mod.IpcChannel(group, rows * chunk * width * 4,
                               device).group


def make_train_step(model: ModelApi, optimizer: Optimizer,
                    cfg: TrainStepConfig, device=None,
                    groups: "Mapping[str, dist_mod.Group] | None" = None):
    """Build the train step for this rank.

    ``groups`` maps each of ``cfg.dp_axes`` to its process group
    (``launch.mesh.make_groups`` for ``("pod", "data")``), and
    ``"model"`` to the model axis's group for the full-manual path; one
    dp axis defaults to the world group (a single rank without
    ``torch.distributed``).  ``device``: where the parameters live;
    ``None`` is CUDA (raises without a card).  Returns ``(step_fn,
    extras)`` with ``step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is the model's parameter tree, or
    this rank's shards of it on a model axis (updated in place),
    ``batch`` the GLOBAL batch, ``extras["aggregator"]`` the aggregator
    (its ``last_schedule`` is the executed plan) and, on a model axis,
    ``extras["mspecs"]`` the leaves' model-axis specs,
    ``extras["model_group"]`` the model group and ``extras["gather"]``
    the gather boundary (shards -> full tree, collective over the model
    group); with ``seq_parallel``, from the first step on,
    ``extras["seq_group"]`` the group the sequence chunks travel on.  A
    caller may set ``extras["inspect"]``: each step then calls
    ``inspect(reduced, gnorm)`` with the aggregated gradient tree (shards
    on a model axis, before the clip) and the global norm the clip
    used.  With telemetry enabled when the step is built
    (``repro_torch.telemetry``), ``step_fn`` is a ``TimedFn``: a
    ``train.step`` wall span and a ``train_step_s`` sample per step."""
    device = resolve_device(device)
    dp_axes = tuple(cfg.dp_axes)
    if groups is None:
        if len(dp_axes) != 1:
            raise ValueError(f"dp axes {dp_axes} need their groups "
                             f"(launch.mesh.make_groups)")
        groups = {dp_axes[0]: dist_mod.Group(name=dp_axes[0])}
    model_group = groups.get(manual_mod.MODEL_AXIS)
    manual = model_group is not None
    agg = GradientAggregator(cfg.aggregator, dp_axes, groups,
                             model_axis=manual_mod.MODEL_AXIS if manual
                             else None)
    shard_groups = [agg.groups[ax] for ax in dp_axes]
    extras = {"aggregator": agg}
    seq = manual and model.seq_parallel and model_group.size > 1
    if manual:
        # The specs from the full tree's shapes, on meta tensors.
        full = model.init(torch.Generator().manual_seed(0), "meta").tree()
        mspecs = manual_mod.model_shard_specs(full, model_group.size)
        mask = manual_mod.sharded_mask(mspecs, mspecs)
        extras.update(mspecs=mspecs, model_group=model_group)
    # Sequence parallelism's collectives run on a group of their own.
    boundary = manual_mod.own_group(model_group) if seq else model_group
    # The gather boundary's group and the sequence chunks' group: on
    # cuda_ipc each with a channel of its own, opened at the first step
    # (collective over the model group).
    gather_group: list = []
    seq_group: list = []

    def gather(params):
        if not manual:
            return params
        if not gather_group:
            gather_group.append(manual_mod.gather_group(
                boundary, params, mspecs, device))
        return manual_mod.gather_params(params, mspecs, gather_group[0],
                                        seq=seq)

    def loss_of(params, batch):
        if not seq:
            return model.loss(gather(params), batch)
        if not seq_group:
            seq_group.append(_seq_channel(boundary, model.spec, batch,
                                          device))
            extras["seq_group"] = seq_group[0]
        return model.loss(gather(params), batch, seq_group=seq_group[0])

    if manual:
        extras["gather"] = gather

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
            loss, metrics = loss_of(params, local)
            grads = run.backward(loss)                  # ← the technique
        else:
            loss, metrics = loss_of(params, local)
            loss.backward()
            # A leaf with no gradient reduces as zeros (JAX's cotangent).
            grads = tree_mod.unflatten(params, [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in leaves])
            grads = agg(grads, groups=groups)          # ← the technique
        reduced = grads
        grads, gnorm = clip_by_global_norm(
            grads, cfg.clip_norm, sharded=mask if manual else None,
            model_group=model_group)
        if "inspect" in extras:
            extras["inspect"](reduced, gnorm)
        del reduced
        opt_state = optimizer.update(grads, opt_state, params)
        for p in leaves:
            p.grad = None
        # A sequence-parallel loss reports the whole step's loss itself.
        metrics = {"loss": loss, **metrics, "grad_norm": gnorm}
        names = sorted(metrics)
        means = agg.mean_scalar(torch.stack(
            [metrics[k].detach().to(torch.float32) for k in names]))
        return params, opt_state, dict(zip(names, means.unbind(0)))

    if telemetry.enabled():
        # A wall span and the train_step_s histogram around each step,
        # closed after a device sync; built only when telemetry is on,
        # so the disabled path returns the raw function.
        return telemetry.trace.timed_call(step_fn, "train.step",
                                          histogram="train_step_s"), extras
    return step_fn, extras
