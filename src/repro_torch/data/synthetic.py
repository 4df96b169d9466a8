"""Synthetic batches (counterpart of ``repro/data/synthetic.py``).

``SyntheticText``: the same closed form as the reference, a noisy affine
token recurrence ``t_{i+1} = (t_i + 17) mod V`` with a 5% chance per
position of a uniform random token.  ``SyntheticImages``: standard-normal
NHWC images and uniform labels for the CNNs.  Deviation: the draws come
from a seeded ``torch.Generator`` and cannot reproduce ``jax.random``'s
bits, so the same seed gives other values than the reference; parity
tests feed both packages batches made with numpy.

``extra_inputs`` gives the modality front end's stub inputs, as in the
reference: image-patch embeddings for the VLM, audio frame embeddings
for the encoder-decoder, none for the other families.
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


@dataclasses.dataclass
class SyntheticImages:
    """Images ``(batch, size, size, 3)`` float32 and labels ``(batch,)``
    int64, drawn on ``device`` (the CPU by default): a global batch at
    224 is 77 MB for 128 images, so a rank on a card draws it there."""
    batch: int
    image_size: int = 224
    num_classes: int = 1000
    seed: int = 0
    device: "str | torch.device | None" = None

    def batch_at(self, step: int) -> dict:
        dev = torch.device(self.device or "cpu")
        gen = torch.Generator(device=dev).manual_seed(self.seed + step)
        images = torch.randn((self.batch, self.image_size, self.image_size,
                              3), generator=gen, device=dev)
        labels = torch.randint(0, self.num_classes, (self.batch,),
                               generator=gen, device=dev)
        return {"images": images, "labels": labels}


def extra_inputs(spec, batch: int, seed: int = 0) -> dict:
    """Stub modality-frontend inputs of ``batch`` rows, bf16
    standard-normal on the CPU from a generator seeded with ``seed``: for
    the VLM ``patches`` ``(batch, num_image_tokens, d_model)``, for the
    audio family ``frames`` ``(batch, encoder_seq, d_model)``; ``{}`` for
    the others."""
    family = getattr(spec, "family", None)
    if family == "vlm":
        shape, key = (batch, spec.num_image_tokens, spec.d_model), "patches"
    elif family == "audio":
        shape, key = (batch, spec.encoder_seq, spec.d_model), "frames"
    else:
        return {}
    gen = torch.Generator().manual_seed(seed)
    return {key: torch.randn(shape, generator=gen).to(torch.bfloat16)}
