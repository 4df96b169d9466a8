"""Batched serving engine: prefill a batch of prompts, then decode
(counterpart of ``repro/serve/engine.py``).

Fixed-batch decode with per-row stop handling.  ``generate`` keeps the
reference's three rules: ``eos_id`` masks rows that have finished and
the loop exits once every row has; the random state is split before its
first use; a prompt (with its image patches, which the reference
leaves out: F8 in ROADMAP.md) plus its generation longer than
``max_seq`` is refused.  Random numbers come from a ``torch.Generator``: the root is
never sampled from; each sample gets a generator seeded from a fresh
draw of the root, so no generator state is used twice.  Sampling is
Gumbel-max (``jax.random.categorical``'s method), so its tokens follow
``softmax(logits / temperature)`` but not the reference's bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..core import dist as dist_mod
from ..kernels.backend import resolve_device
from ..launch.mesh import DP_AXES
from ..models import ModelApi
from .step import make_decode_step, make_prefill_step


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_seq: int = 256
    eos_id: int = -1              # -1 = never stop early
    greedy: bool = True
    temperature: float = 1.0


def _split(root: torch.Generator, device) -> torch.Generator:
    """A new generator on ``device`` seeded from one draw of ``root``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=root))
    return torch.Generator(device=device).manual_seed(seed)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host.  On the card the process's ``cuda_ipc``
    channels sync first: their waits on the card have no timeout of
    their own, and a peer that never posts raises there, naming it."""
    if t.is_cuda:
        dist_mod.sync_channels()
    return t.cpu()


class ServeEngine:
    """``params``: the full tree (or a module with ``.tree()``), or this
    rank's shards when ``groups`` has a model axis.  ``groups``: the
    mesh's process groups (``launch.mesh.make_groups``), None on one
    rank.  ``device``: None is CUDA (raises without a card)."""

    def __init__(self, model: ModelApi, params, groups=None,
                 cfg: Optional[ServeConfig] = None, device=None):
        self.model = model
        self.params = params
        self.groups = groups
        self.dp_axes = tuple(ax for ax in DP_AXES if ax in (groups or {}))
        self.cfg = cfg if cfg is not None else ServeConfig()
        self.device = resolve_device(device)
        self._prefill = None
        self._prefill_key = None
        self._decode = None
        self._decode_key = None
        self.timing: dict = {}

    @staticmethod
    def _batch_key(batch: dict):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items()))

    def generate(self, batch: dict, rng: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """batch: ``{"tokens": (B, S_prompt)}`` (and the VLM's
        ``"patches"`` (B, n_img, d)), the GLOBAL batch.
        Returns ``(B, max_new_tokens)`` int32 generations, the same on
        every rank.  ``self.timing`` then holds ``prefill_s`` (prompt to
        first token) and ``decode_s`` (one per decode step), host
        seconds up to the token's arrival on the host."""
        if not self.model.has_decode:
            raise ValueError(f"{self.model.spec.name} has no decode step")
        cfg = self.cfg
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        b = tokens.shape[0]
        # The image patches take cache positions before the text.
        n_img = int(batch["patches"].shape[1]) if "patches" in batch else 0
        prompt_len = int(tokens.shape[1]) + n_img
        if prompt_len + cfg.max_new_tokens > cfg.max_seq:
            with_img = f", {n_img} image patches included" if n_img else ""
            raise ValueError(
                f"prompt_len ({prompt_len}{with_img}) + "
                f"max_new_tokens ({cfg.max_new_tokens}) = "
                f"{prompt_len + cfg.max_new_tokens} exceeds "
                f"ServeConfig.max_seq ({cfg.max_seq}): the decode cache "
                f"is allocated at max_seq positions and token "
                f"{cfg.max_seq - prompt_len} would write past it.  "
                f"Raise max_seq, shorten the prompt, or lower "
                f"max_new_tokens.")

        tracer = telemetry.get_tracer()
        # The decode step is keyed by what its region depends on, so a new
        # prompt length rebuilds the prefill alone, on the same region: one
        # gather boundary and one set of channels for both steps.
        dkey = (b, cfg.max_seq)
        if self._decode_key != dkey:
            self._decode = make_decode_step(self.model, self.groups,
                                            self.dp_axes, b, cfg.max_seq,
                                            self.device)
            self._decode_key = dkey
        pkey = (self._batch_key(batch), cfg.max_seq)
        if self._prefill_key != pkey:
            self._prefill = make_prefill_step(
                self.model, self.groups, self.dp_axes, batch, cfg.max_seq,
                self.device, region=self._decode.region)
            self._prefill_key = pkey
        t0 = time.perf_counter()
        with tracer.span("serve.prefill", cat="wall", batch=int(b),
                         prompt_len=prompt_len) as sp:
            logits, cache = self._prefill(self.params, batch)
            if tracer.enabled:
                telemetry.trace.sync_devices((logits, cache))
        if tracer.enabled:
            telemetry.METRICS.histogram(
                "serve_prefill_s",
                help="host-timed prefill latency (s)"
            ).observe(sp.t1 - sp.t0)

        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        # Split BEFORE the first sample: the root generator is only ever
        # drawn from for seeds, never sampled from.
        cur = self._sample(logits, _split(rng, logits.device))
        out = []
        finished = torch.zeros((b,), dtype=torch.bool) \
            if cfg.eos_id >= 0 else None
        host = _to_host(cur)
        self.timing = {"prefill_s": time.perf_counter() - t0,
                       "decode_s": []}
        for t in range(cfg.max_new_tokens):
            if finished is not None:
                # rows that already emitted EOS keep emitting it
                host = torch.where(finished, cfg.eos_id, host)
            out.append(host.numpy().astype(np.int32))
            if finished is not None:
                finished = finished | (host == cfg.eos_id)
                if bool(finished.all()):
                    # every row is done: pad the remaining positions
                    # without running the decode step
                    pad = np.full((b,), cfg.eos_id, np.int32)
                    out.extend(pad for _ in
                               range(cfg.max_new_tokens - len(out)))
                    break
            t1 = time.perf_counter()
            with tracer.span("serve.decode", cat="wall", token=t) as sp:
                logits, cache = self._decode(self.params, cache,
                                             host.to(torch.int64)[:, None])
                cur = self._sample(logits, _split(rng, logits.device))
                if tracer.enabled:
                    telemetry.trace.sync_devices(cur)
            if tracer.enabled:
                telemetry.METRICS.histogram(
                    "serve_decode_s",
                    help="host-timed per-token decode latency (s)"
                ).observe(sp.t1 - sp.t0)
            host = _to_host(cur)
            self.timing["decode_s"].append(time.perf_counter() - t1)
        return np.stack(out, axis=1)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator):
        if self.cfg.greedy:
            return torch.argmax(logits, dim=-1)
        # Gumbel-max: argmax(logits / T + Gumbel noise) is a draw from
        # softmax(logits / T).
        x = logits.to(torch.float32) / self.cfg.temperature
        u = torch.rand(x.shape, generator=gen, device=x.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
