"""Model registry and the fusion-group tags of each parameter
(counterpart of ``repro/models/registry.py``: the transformer families
``dense``, ``moe`` and ``vlm``, the Mamba2 hybrid ``hybrid``, the xLSTM
``ssm``, the encoder-decoder ``audio``, and the paper's CNNs through
:func:`build_cnn`).

``param_pspecs`` gives the reference's PartitionSpec per leaf (the
model-axis rules, path-sensitive for the experts: a leaf under ``moe``
but not under ``shared`` shards its expert dim) as a tuple, one entry
per dim; ``param_groups`` gives the same tuples as fusion-group tags, so
the aggregator buckets gradients exactly as the reference does: leaves
with a ``"model"`` entry stay single-leaf buckets, replicated leaves
(tag ``()``) fuse.  ``divisibility_check`` lists the leaves whose
sharded dim the model axis does not divide.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .. import tree as tree_mod
from . import cnn, encdec, hybrid, ssm_lm, transformer
from .common import ModelModule, ModelSpec, ParamTree

_COL = (None, "model")
_ROW = ("model", None)

# The reference's table.
_RULES: dict[str, tuple] = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "wdkv": _COL, "wuk": _COL, "wuv": _COL,
    "w1": _COL, "w_gate": _COL, "w2": _ROW,
    # mamba2
    "z_proj": _COL, "xbc_proj": _COL, "dt_proj": (None, None),
    "conv_w": (None, "model"), "out_proj": _ROW,
    # xlstm
    "up_proj": _COL, "wi": (None, None), "wf": (None, None),
    "wo_gate": _COL, "down_proj": _ROW, "w_in": _COL,
    "r_rec": (None, None, None),
    "router": (None, None),
}

# Routed experts (under "moe", not under "shared"): the expert dim.
_MOE_RULES: dict[str, tuple] = {
    "w1": ("model", None, None),
    "w_gate": ("model", None, None),
    "w2": ("model", None, None),
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """``init(generator, device) -> module`` (its ``.tree()`` is the
    parameter tree); ``loss(params_tree, batch) -> (loss, metrics)``;
    for serving ``prefill(params, batch, max_seq) -> (last logits,
    cache)``, ``decode_step(params, cache, tokens) -> (logits, cache)``
    and ``init_cache(batch, seq, device=None)``.  ``seq_parallel``: the
    loss splits the sequence over a model group given as
    ``loss(params, batch, seq_group=group)`` (``spec.seq_parallel`` on a
    transformer family; ``models/transformer.py``)."""
    spec: "ModelSpec | cnn.CnnSpec"
    init: Callable
    loss: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    has_decode: bool = True
    seq_parallel: bool = False


def build_model(spec: ModelSpec) -> ModelApi:
    if spec.family in transformer.FAMILIES:
        return ModelApi(
            spec=spec,
            init=lambda gen, device=None: transformer.TransformerLM(
                spec, transformer.init_params(gen, spec, device)),
            loss=lambda p, b, seq_group=None: transformer.loss_fn(
                p, b, spec, seq_group=seq_group),
            prefill=lambda p, b, max_seq=None: transformer.prefill(
                p, b["tokens"], spec, patches=b.get("patches"),
                max_seq=max_seq),
            decode_step=lambda p, c, t: transformer.decode_step(p, c, t,
                                                                spec),
            init_cache=lambda batch, seq, device=None:
                transformer.init_cache(spec, batch, seq, device),
            seq_parallel=bool(spec.seq_parallel))
    if spec.family == "audio":
        return ModelApi(
            spec=spec,
            init=lambda gen, device=None: ModelModule(
                spec, encdec.init_params(gen, spec, device), encdec.loss_fn),
            loss=lambda p, b: encdec.loss_fn(p, b, spec),
            prefill=lambda p, b, max_seq=None: encdec.prefill(
                p, b["tokens"], b["frames"], spec, max_seq=max_seq),
            decode_step=lambda p, c, t: encdec.decode_step(p, c, t, spec),
            init_cache=lambda batch, seq, device=None: encdec.init_cache(
                spec, batch, seq, device))
    mods = {"hybrid": hybrid, "ssm": ssm_lm}
    if spec.family not in mods:
        raise ValueError(f"unknown family {spec.family!r}")
    mod = mods[spec.family]
    return ModelApi(
        spec=spec,
        init=lambda gen, device=None: ModelModule(
            spec, mod.init_params(gen, spec, device), mod.loss_fn),
        loss=lambda p, b: mod.loss_fn(p, b, spec),
        prefill=lambda p, b, max_seq=None: mod.prefill(
            p, b["tokens"], spec, max_seq=max_seq),
        decode_step=lambda p, c, t: mod.decode_step(p, c, t, spec),
        init_cache=lambda batch, seq, device=None: mod.init_cache(
            spec, batch, seq, device))


def build_cnn(spec: cnn.CnnSpec) -> ModelApi:
    """ResNet-50 (``spec.name == "resnet50"``) or MobileNet-v1
    (``"mobilenet"``); batches are ``{"images": (B, H, W, 3), "labels"}``."""
    if spec.name not in cnn.CNNS:
        raise ValueError(f"unknown CNN {spec.name!r}; one of "
                         f"{sorted(cnn.CNNS)}")
    init_fn, forward = cnn.CNNS[spec.name]
    return ModelApi(
        spec=spec,
        init=lambda gen, device=None: ParamTree(init_fn(gen, device)),
        loss=lambda p, b: cnn.cnn_loss(forward, p, b, spec),
        has_decode=False)


def _spec_for(path: tuple, leaf) -> tuple:
    names = [str(k) for k in path]
    name = names[-1] if names else ""
    in_moe = "moe" in names and "shared" not in names
    base = _MOE_RULES.get(name) if in_moe else None
    if base is None:
        base = _RULES.get(name)
    if base is None:
        return ()
    nd = leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)
    if nd == len(base):
        return base
    if nd == len(base) + 1:        # stacked over layers
        return (None,) + base
    return ()


def param_pspecs(params) -> dict:
    """The model-axis spec of every leaf: a tuple with one entry per dim
    (``None`` or ``"model"``), ``()`` for a replicated leaf."""
    flat = tree_mod.leaves_with_path(params)
    return tree_mod.unflatten(params, [_spec_for(path, leaf)
                                       for path, leaf in flat])


param_groups = param_pspecs     # the fusion-group tag of each leaf


def divisibility_check(params, model_axis_size: int) -> list:
    """``(path, shape)`` of every leaf with a model-sharded dim that
    ``model_axis_size`` does not divide, paths joined by ``/``."""
    bad = []
    for path, leaf in tree_mod.leaves_with_path(params):
        spec = _spec_for(path, leaf)
        for dim, s in zip(leaf.shape, tuple(spec) + (None,) * 8):
            if s == "model" and dim % model_axis_size != 0:
                bad.append(("/".join(str(k) for k in path),
                            tuple(leaf.shape)))
    return bad
