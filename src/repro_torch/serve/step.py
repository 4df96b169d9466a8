"""Serving steps: prefill (prompt -> cache) and decode (one token).

Counterpart of ``repro/serve/step.py``.  There is no jit: each
``make_*_step`` returns a callable that runs under
``torch.inference_mode()`` on this rank's rows of a GLOBAL batch.

* Rows.  The dp axes (``groups[ax]`` for ``ax`` in ``dp_axes``, outermost
  first) split the rows as ``train/step.py::shard_batch`` does when their
  size divides the batch; otherwise every rank runs every row, as the
  reference's replicated token spec does.  The cache holds this rank's
  rows (``cache_pspecs``' batch entry).
* The model axis (``groups["model"]`` of size > 1): the rank holds its
  shards of the parameters (``core/manual.py::shard_params``) and each
  call rebuilds the full weights through ``manual.gather_params`` before
  the forward, as the reference's full-manual ``shard_map`` region does.
  The cache stays replicated over the model axis (:func:`strip_axis`):
  the gathered forward computes the same full tensors on every model
  rank.
* Logits.  Every row's logits come back to every rank (all-gathered
  over the dp axes, as the reference's logit spec gathers them), so
  every rank samples the same tokens.

On ``cuda_ipc`` the gather boundary and the logits' all-gathers each
open an ``IpcChannel`` of their own at the first call (collective over
their group).
"""
from __future__ import annotations

import torch

from .. import tree as tree_mod
from ..core import dist as dist_mod
from ..core import manual as manual_mod
from ..kernels.backend import resolve_device
from ..models import ModelApi
from .sharding import axis_sizes, cache_pspecs


def sanitize_pspec(spec, axis_names) -> tuple:
    """Drop axis names that ``axis_names`` (a mesh's, or a mapping of
    groups' keys) does not have."""
    names = set(axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return tuple(keep(e) for e in tuple(spec))


def strip_axis(spec, axis: str = "model") -> tuple:
    """The spec with every ``axis`` entry removed (replicated over it)."""
    def keep(entry):
        if entry == axis:
            return None
        if isinstance(entry, tuple):
            kept = tuple(e for e in entry if e != axis)
            return kept if kept else None
        return entry

    return tuple(keep(e) for e in tuple(spec))


def _manual_serve(model: ModelApi, groups) -> bool:
    """Take the tensor-parallel path?  A real model axis, and no
    sequence parallelism (the train step's gate)."""
    g = (groups or {}).get(manual_mod.MODEL_AXIS)
    return (g is not None and g.size > 1
            and not bool(getattr(model.spec, "seq_parallel", False)))


def _bind(group, nbytes: int, device):
    """``group`` ready to all-gather ``nbytes`` a rank (a channel of its
    own on ``cuda_ipc``)."""
    if group.transport != "cuda_ipc" or group.size == 1:
        return group
    # The slots are made outside inference mode: inference tensors could
    # not be written by a later call made outside it.
    with torch.inference_mode(False):
        return dist_mod.IpcChannel(group, nbytes, device).group


class _Region:
    """What both steps share: this rank's rows, the gather boundary and
    the logits' all-gather over the dp axes."""

    def __init__(self, model: ModelApi, groups, dp_axes, batch: int,
                 max_seq: int, device):
        self.device = resolve_device(device)
        self.dp_groups = [groups[ax] for ax in dp_axes] if groups else []
        tpl = model.init_cache(batch, max_seq, device="meta")
        self.cache_specs = cache_pspecs(tpl, groups, dp_axes)
        # The cache's batch entry (dim 1 of every stacked leaf) decides
        # the rows this rank runs.
        stacked = [sp for sp in tree_mod.leaves(self.cache_specs)
                   if len(sp) >= 2]
        self.split = stacked[0][1] is not None
        dp_size, _ = axis_sizes(groups, dp_axes)
        index = 0
        for g in self.dp_groups:
            index = index * g.size + g.rank
        per = batch // dp_size if self.split else batch
        self.rows = slice(index * per, (index + 1) * per) if self.split \
            else slice(0, batch)
        self.manual = _manual_serve(model, groups)
        if self.manual:
            self.cache_specs = tree_mod.tree_map(strip_axis,
                                                 self.cache_specs)
            full = model.init(torch.Generator().manual_seed(0),
                              "meta").tree()
            self.model_group = groups[manual_mod.MODEL_AXIS]
            self.mspecs = manual_mod.model_shard_specs(full,
                                                       self.model_group.size)
        self._gather_group = None
        self._logit_groups = None

    def local(self, x) -> torch.Tensor:
        return torch.as_tensor(x)[self.rows].to(self.device)

    def full(self, params):
        if hasattr(params, "tree"):
            params = params.tree()
        if not self.manual:
            return params
        if self._gather_group is None:
            with torch.inference_mode(False):       # as in _bind
                self._gather_group = manual_mod.gather_group(
                    self.model_group, params, self.mspecs, self.device)
        return manual_mod.gather_params(params, self.mspecs,
                                        self._gather_group)

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        """Every row's logits, rows in global order."""
        if not self.split:
            return logits
        if self._logit_groups is None:
            nbytes, groups = logits.nbytes, []
            for g in reversed(self.dp_groups):      # innermost first
                groups.append(_bind(g, nbytes, self.device))
                nbytes *= g.size
            self._logit_groups = groups
        for g in self._logit_groups:
            logits = dist_mod.all_gather(logits.contiguous(), g).reshape(
                (-1,) + tuple(logits.shape[1:]))
        return logits


def _expose(step, region):
    step.region = region
    step.cache_specs = region.cache_specs
    step.rows = region.rows
    step.full = region.full
    return step


def make_prefill_step(model: ModelApi, groups, dp_axes, batch_example,
                      max_seq: int, device=None, region=None):
    """``step(params, batch) -> (logits (B, V) of every row, cache of
    this rank's rows)``; ``params`` the full tree, or this rank's shards
    on a model axis; ``batch`` the GLOBAL batch.  ``region``: another
    step's for the same batch size and ``max_seq``, whose gather boundary
    and channels this step then shares.  ``step.cache_specs``: the
    cache's spec per leaf (model-replicated); ``step.rows``: this rank's
    rows; ``step.full(params)``: the gather boundary alone;
    ``step.region``: all three."""
    b = int(batch_example["tokens"].shape[0])
    if region is None:
        region = _Region(model, groups, tuple(dp_axes), b, max_seq, device)

    @torch.inference_mode()
    def step(params, batch):
        local = {k: region.local(v) for k, v in batch.items()}
        logits, cache = model.prefill(region.full(params), local, max_seq)
        return region.gather(logits), cache

    return _expose(step, region)


def make_decode_step(model: ModelApi, groups, dp_axes, batch: int,
                     max_seq: int, device=None):
    """``step(params, cache, tokens (B, 1)) -> (logits (B, V) of every
    row, cache)``: ``tokens`` of every row, ``cache`` this rank's (its
    buffers written in place).  Attributes as the prefill step's."""
    region = _Region(model, groups, tuple(dp_axes), batch, max_seq, device)

    @torch.inference_mode()
    def step(params, cache, tokens):
        logits, cache = model.decode_step(region.full(params), cache,
                                          region.local(tokens))
        return region.gather(logits), cache

    return _expose(step, region)
