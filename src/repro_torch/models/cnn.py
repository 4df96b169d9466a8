"""The paper's own workloads: ResNet-50 and MobileNet-v1 in PyTorch.

Counterpart of ``repro/models/cnn.py``, used by the data-parallel CNN
step (the tf_cnn_benchmarks analogue: synthetic images, SGD, each
gradient-aggregation strategy).  BN is folded to per-channel
scale/bias frozen at init, as in the reference.

Parameters keep the reference's layout and names — HWIO conv weights,
depthwise ``(3, 3, 1, cin)``, f32 BN ``scale``/``bias``, ``fc.w`` of
shape ``(cin, 1000)`` — so ``convert.py`` carries the reference's trees
unchanged and gradient buckets flatten element for element like the
reference's.  Activations are NHWC at every function's boundary, as in
the reference; :func:`conv` permutes to NCHW views (channels_last in
memory, what cuDNN wants) and back, and the weight to OIHW, only around
``F.conv2d``.

Padding is TF/XLA ``"SAME"``, which is asymmetric where the stride is 2
(the 7×7/2 stem pads (2, 3) at 224, a 3×3/2 conv (0, 1) on even sizes):
:func:`same_pads` computes it and :func:`conv` pads explicitly where the
two sides differ.  The stem's max-pool pads with −inf the same way.
Convolutions stay cuDNN's and the head ``torch.matmul``: the reference
computes them with XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .common import _DTYPES, cross_entropy


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    name: str
    num_classes: int = 1000
    image_size: int = 224
    dtype: str = "bfloat16"        # compute dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _conv_init(gen, kh, kw, cin, cout, device=None):
    fan_in = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       device=device) / math.sqrt(fan_in)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """``(lo, hi)`` padding of one spatial dim under TF/XLA ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """Pad an NCHW view for ``"SAME"``; returns ``(x, (ph, pw))``: an
    explicit ``F.pad`` where lo != hi, else the op's own symmetric pad."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if (hl, wl) == (hh, wh):
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(x, w, stride: int = 1, groups: int = 1):
    """NHWC ``x`` with an HWIO ``w`` (depthwise: ``(kh, kw, 1, cin)`` and
    ``groups=cin``), ``"SAME"`` padding, in ``x``'s dtype."""
    xc, pad = _pad_same(_nchw(x), w.shape[0], stride)
    wc = w.permute(3, 2, 0, 1).to(x.dtype, memory_format=torch.channels_last)
    return _nhwc(F.conv2d(xc, wc, stride=stride, padding=pad, groups=groups))


def max_pool_same(x):
    """The stem's 3×3/2 ``reduce_window`` max with −inf ``"SAME"``
    padding."""
    xc, pad = _pad_same(_nchw(x), 3, 2, value=-math.inf)
    return _nhwc(F.max_pool2d(xc, 3, 2, padding=pad))


def bn_act(x, p, relu: bool = True):
    x = x * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return torch.relu(x) if relu else x


def _bn_params(c, device=None):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _fc_params(gen, cin, device=None):
    return {"w": torch.randn((cin, 1000), generator=gen, device=device)
            * 0.01,
            "b": torch.zeros((1000,), dtype=torch.float32, device=device)}


def _head(x, fc):
    x = x.mean(dim=(1, 2))
    return x @ fc["w"].to(x.dtype) + fc["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

_R50_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def resnet50_params(gen: torch.Generator, device=None) -> dict:
    """The reference's tree (seeded torch draws, not ``jax.random``'s)."""
    p = {"stem": {"w": _conv_init(gen, 7, 7, 3, 64, device),
                  "bn": _bn_params(64, device)},
         "stages": []}
    cin = 64
    for si, (blocks, width) in enumerate(_R50_STAGES):
        stage = []
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            cout = width * 4
            blk = {
                "w1": _conv_init(gen, 1, 1, cin, width, device),
                "bn1": _bn_params(width, device),
                "w2": _conv_init(gen, 3, 3, width, width, device),
                "bn2": _bn_params(width, device),
                "w3": _conv_init(gen, 1, 1, width, cout, device),
                "bn3": _bn_params(cout, device),
            }
            if cin != cout or stride != 1:
                blk["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
                blk["bn_proj"] = _bn_params(cout, device)
            stage.append(blk)
            cin = cout
        p["stages"].append(stage)
    p["fc"] = _fc_params(gen, cin, device)
    return p


def resnet50_forward(params, images, spec: CnnSpec):
    x = images.to(spec.compute_dtype)
    x = bn_act(conv(x, params["stem"]["w"], stride=2), params["stem"]["bn"])
    x = max_pool_same(x)
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            sc = x
            h = bn_act(conv(x, blk["w1"]), blk["bn1"])
            h = bn_act(conv(h, blk["w2"], stride=stride), blk["bn2"])
            h = bn_act(conv(h, blk["w3"]), blk["bn3"], relu=False)
            if "proj" in blk:
                sc = bn_act(conv(sc, blk["proj"], stride=stride),
                            blk["bn_proj"], relu=False)
            x = torch.relu(h + sc)
    return _head(x, params["fc"])


# ---------------------------------------------------------------------------
# MobileNet-v1
# ---------------------------------------------------------------------------

_MBN_LAYERS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
               (1024, 1)]


def mobilenet_params(gen: torch.Generator, device=None) -> dict:
    p = {"stem": {"w": _conv_init(gen, 3, 3, 3, 32, device),
                  "bn": _bn_params(32, device)}, "blocks": []}
    cin = 32
    for cout, _ in _MBN_LAYERS:
        p["blocks"].append({
            "dw": _conv_init(gen, 3, 3, 1, cin, device),   # depthwise
            "bn1": _bn_params(cin, device),
            "pw": _conv_init(gen, 1, 1, cin, cout, device),
            "bn2": _bn_params(cout, device),
        })
        cin = cout
    p["fc"] = _fc_params(gen, cin, device)
    return p


def mobilenet_forward(params, images, spec: CnnSpec):
    x = images.to(spec.compute_dtype)
    x = bn_act(conv(x, params["stem"]["w"], stride=2), params["stem"]["bn"])
    for blk, (_, stride) in zip(params["blocks"], _MBN_LAYERS):
        cin = blk["dw"].shape[3]
        x = bn_act(conv(x, blk["dw"], stride=stride, groups=cin), blk["bn1"])
        x = bn_act(conv(x, blk["pw"]), blk["bn2"])
    return _head(x, params["fc"])


def cnn_loss(forward_fn, params, batch, spec: CnnSpec):
    logits = forward_fn(params, batch["images"], spec)
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"ce": loss.detach()}


# name -> (init, forward)
CNNS = {"resnet50": (resnet50_params, resnet50_forward),
        "mobilenet": (mobilenet_params, mobilenet_forward)}

# Analytic entries for the scaling study (params, fwd GFLOPs/image).
PAPER_MODELS = {
    "resnet50": {"params": 25.6e6, "gflops": 3.9},
    "mobilenet": {"params": 4.2e6, "gflops": 0.57},
    "nasnet-large": {"params": 88.9e6, "gflops": 23.8},
}
