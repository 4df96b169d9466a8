"""Synthetic LM batches (counterpart of ``repro/data/synthetic.py``).

The same closed form as the reference: a noisy affine token recurrence
``t_{i+1} = (t_i + 17) mod V``, with a 5% chance per position of a
uniform random token.  Deviation: the draws come from a seeded
``torch.Generator`` and cannot reproduce ``jax.random``'s bits, so the
same seed gives other tokens than the reference; parity tests feed both
packages batches made with numpy.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SyntheticText:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.05

    def batch_at(self, step: int) -> dict:
        gen = torch.Generator().manual_seed(self.seed + step * 9973)
        v = self.vocab_size
        t0 = torch.randint(0, v, (self.batch, 1), generator=gen)
        i = torch.arange(self.seq_len + 1)
        toks = (t0 + i[None, :] * 17) % v
        flip = torch.rand((self.batch, self.seq_len + 1),
                          generator=gen) < self.noise
        rand = torch.randint(0, v, (self.batch, self.seq_len + 1),
                             generator=gen)
        toks = torch.where(flip, rand, toks).to(torch.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
