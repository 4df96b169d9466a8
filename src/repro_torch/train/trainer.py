"""Training loop and checkpoints (counterpart of
``repro/train/trainer.py``)."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch
import torch.distributed as dist

from .. import checkpoint
from .. import tree as tree_mod
from ..core import dist as dist_mod
from ..core import manual as manual_mod
from ..kernels.backend import resolve_device
from ..models import ModelApi
from ..models.common import ParamTree
from ..optim import Optimizer
from .step import TrainStepConfig, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = no checkpointing
    ckpt_dir: str = "checkpoints"
    step: TrainStepConfig = dataclasses.field(default_factory=TrainStepConfig)


class Trainer:
    """``data_iter_fn(step)`` returns the GLOBAL batch of a step; each
    rank trains on its shard.  ``groups``/``device`` as in
    :func:`~repro_torch.train.step.make_train_step`; with a ``"model"``
    group each rank keeps its shards of the parameters
    (:meth:`init_state`), and :meth:`full_params` gathers them."""

    def __init__(self, model: ModelApi, optimizer: Optimizer,
                 data_iter_fn: Callable[[int], dict], cfg: TrainerConfig,
                 device=None, verbose: bool = True, groups=None):
        self.model = model
        self.optimizer = optimizer
        self.data_iter_fn = data_iter_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.verbose = verbose
        self.step_fn, self.extras = make_train_step(
            model, optimizer, cfg.step, device=self.device, groups=groups)

    def init_state(self, seed: int = 0):
        """``(module, opt_state)`` with parameters from a seeded
        generator on the device (every rank draws the same values).  On
        a model axis the full tree is drawn, then only this rank's
        shards are kept (``module`` is a ``ParamTree`` of them)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        module = self.model.init(gen, self.device)
        if "mspecs" in self.extras:
            module = ParamTree(manual_mod.shard_params(
                module.tree(), self.extras["mspecs"],
                self.extras["model_group"]))
        return module, self.optimizer.init(module.tree())

    @torch.no_grad()
    def full_params(self, params) -> dict:
        """The full parameter tree from this rank's ``params`` (a
        collective over the model group on a model axis; the tree
        itself otherwise)."""
        gather = self.extras.get("gather")
        return params if gather is None else gather(params)

    @torch.no_grad()
    def full_state(self, params, opt_state) -> dict:
        """``{"params", "opt"}`` in full: on a model axis the parameters
        and the optimizer's per-parameter state are gathered (a
        collective over the model group)."""
        gather = self.extras.get("gather")
        if gather is None:
            return {"params": params, "opt": opt_state}
        shape = tree_mod.structure(params)
        opt = {k: gather(v) if tree_mod.structure(v) == shape else v
               for k, v in opt_state.items()}
        return {"params": self.full_params(params), "opt": opt}

    def save_checkpoint(self, step: int, params, opt_state) -> None:
        """``checkpoint.save`` of the full state at ``step``, written by
        global rank 0 only (every rank must call it on a model axis)."""
        state = self.full_state(params, opt_state)
        if not dist.is_initialized() or dist.get_rank() == 0:
            checkpoint.save(self.cfg.ckpt_dir, step, state)

    def _sync(self):
        """The step's end on the card: the channels first, whose waits
        on the card have no timeout of their own (a peer that never
        posts raises, naming it), then the device."""
        if self.device.type == "cuda":
            dist_mod.sync_channels()
            torch.cuda.synchronize(self.device)

    def _align(self):
        """Every rank of the step's groups leaves here together: a
        barrier on each group in turn (orthogonal axes chain into one
        barrier over the mesh).  The reference's step is one program
        that starts on every device at once; here each rank reaches the
        step after its own device sync and host work, and ranks that
        share a card are released by its time slices in turn, so without
        this a rank that starts early waits in its first collective for
        the others."""
        for g in self.extras["aggregator"].groups.values():
            if g.size > 1:
                dist.barrier(group=g.pg)

    def run(self, steps: int | None = None, module=None, opt_state=None,
            start_step: int = 0):
        """Train ``steps`` steps (default: up to ``cfg.steps``).  Returns
        ``(module, opt_state, history)``; ``history`` has one record per
        step: the rank-mean metrics, ``step_s`` (host clock around a
        synchronised step, from a start common to the step's ranks,
        :meth:`_align`) and ``n_buckets``."""
        if module is None:
            module, opt_state = self.init_state()
        elif opt_state is None:
            opt_state = self.optimizer.init(module.tree())
        steps = self.cfg.steps - start_step if steps is None else steps
        params = module.tree()
        history = []
        for step in range(start_step, start_step + steps):
            batch = self.data_iter_fn(step)
            self._sync()
            self._align()
            # No cyclic collection inside the step: a collector pause on
            # one rank holds up its peers in every collective the step
            # runs (in the backward, with overlap).  It runs between
            # steps, before the next one's barrier.
            collect = gc.isenabled()
            gc.disable()
            try:
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                self._sync()
            finally:
                if collect:
                    gc.enable()
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["step_s"] = time.perf_counter() - t0
            m["n_buckets"] = \
                self.extras["aggregator"].last_schedule.n_buckets
            history.append(m)
            if self.verbose and ((step + 1) % self.cfg.log_every == 0
                                 or step == start_step + steps - 1):
                print(f"step {step + 1:5d} "
                      + " ".join(f"{k}={v:.4g}" for k, v in m.items()
                                 if k != "step"), flush=True)
            if self.cfg.ckpt_every and (step + 1) % self.cfg.ckpt_every == 0:
                self.save_checkpoint(step + 1, params, opt_state)
        return module, opt_state, history
