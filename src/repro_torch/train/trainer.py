"""Training loop (counterpart of ``repro/train/trainer.py``; checkpoints
are not ported yet)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..kernels.backend import resolve_device
from ..models import ModelApi
from ..optim import Optimizer
from .step import TrainStepConfig, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    step: TrainStepConfig = dataclasses.field(default_factory=TrainStepConfig)


class Trainer:
    """``data_iter_fn(step)`` returns the GLOBAL batch of a step; each
    rank trains on its shard.  ``groups``/``device`` as in
    :func:`~repro_torch.train.step.make_train_step`."""

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
        generator on the device (every rank draws the same values)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        module = self.model.init(gen, self.device)
        return module, self.optimizer.init(module.tree())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, steps: int | None = None, module=None, opt_state=None,
            start_step: int = 0):
        """Train ``steps`` steps (default: up to ``cfg.steps``).  Returns
        ``(module, opt_state, history)``; ``history`` has one record per
        step: the rank-mean metrics, ``step_s`` (host clock around a
        synchronised step) and ``n_buckets``."""
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
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            self._sync()
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
        return module, opt_state, history
