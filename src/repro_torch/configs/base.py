"""Config substrate: the input-shape registry and per-arch shape policy.

Counterpart of ``repro/configs/base.py``, with its shapes, its
``long_500k`` policy and its SKIP reasons:

* the four input shapes (:data:`SHAPES`);
* ``input_specs(spec, shape_name)`` — a meta tensor (no storage) for
  every input of the step a shape runs: tokens and labels for training,
  tokens for prefill, one token per row and the KV or state cache for
  decode (``init_cache`` on ``meta``), plus the audio frames or image
  patches of the families that take them;
* the ``long_500k`` applicability policy per family.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as tree_mod
from ..models import build_model
from ..models.common import ModelSpec


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# sliding window used for the dense long-context variant (gemma-7b)
LONG_CONTEXT_WINDOW = 8192


def long500k_policy(spec: ModelSpec) -> str:
    """'native' (O(1)/latent state), 'window' (SWA variant), or 'skip'."""
    if spec.family in ("ssm", "hybrid"):
        return "native"
    if spec.kv_lora_rank:        # MLA latent cache: (r+rd) bytes/token
        return "native"
    if spec.name.startswith("gemma"):
        return "window"
    return "skip"


def shape_supported(spec: ModelSpec, shape_name: str) -> tuple[bool, str]:
    if shape_name != "long_500k":
        return True, ""
    pol = long500k_policy(spec)
    if pol == "skip":
        return False, (f"{spec.name} is pure full-attention: a 500k dense "
                       "KV cache is architecturally quadratic-memory; "
                       "skipped per DESIGN.md §3.4")
    return True, pol


def spec_for_shape(spec: ModelSpec, shape_name: str) -> ModelSpec:
    """Per-shape spec variants (e.g. gemma SWA for long_500k)."""
    if shape_name == "long_500k" and long500k_policy(spec) == "window":
        return dataclasses.replace(spec, sliding_window=LONG_CONTEXT_WINDOW)
    return spec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(spec: ModelSpec, shape_name: str) -> dict:
    """Meta tensors for every input of the step ``shape_name`` runs.

    train  -> {"tokens", "labels"} (+frames/patches for audio/vlm)
    prefill-> {"tokens"} (+frames/patches)
    decode -> {"tokens" (B,1), "cache"}
    """
    shp = SHAPES[shape_name]
    spec = spec_for_shape(spec, shape_name)
    b, s = shp.global_batch, shp.seq_len
    i32 = torch.int32

    extras = {}
    if spec.family == "audio":
        extras["frames"] = _meta((b, spec.encoder_seq, spec.d_model),
                                 torch.bfloat16)
    if spec.family == "vlm" and shp.kind != "decode":
        extras["patches"] = _meta((b, spec.num_image_tokens, spec.d_model),
                                  torch.bfloat16)

    if shp.kind == "train":
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32),
                **extras}
    if shp.kind == "prefill":
        return {"tokens": _meta((b, s), i32), **extras}

    # decode: one token + a cache of length s
    cache = build_model(spec).init_cache(b, s, device="meta")
    cache = tree_mod.tree_map(
        lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, cache)
    return {"tokens": _meta((b, 1), i32), "cache": cache}
