"""Shared model substrate: spec dataclass, norms, RoPE, init, loss.

Counterpart of ``repro/models/common.py``.  ``ModelSpec`` keeps every
field and default of the reference (so ``reduced()`` gives the same
sizes); :class:`ParamTree` holds a nested tree of dicts and lists of
parameters as an ``nn.Module`` under the reference's names.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from ..kernels.fused_rmsnorm import RMSNormFn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture hyper-parameters (the reference's fields)."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    scale_embed: bool = False
    attention_type: str = "gqa"
    sliding_window: int = 0
    attn_chunk: int = 1024
    attn_full_seq_max: int = 2048
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 4096
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0
    slstm_every: int = 0
    mlstm_chunk: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_image_tokens: int = 0
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"
    remat: bool = False
    seq_parallel: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def reduced(self) -> "ModelSpec":
        """Smoke-test variant: same family/code path, tiny sizes (the
        reference's rule)."""
        r = {
            "name": self.name + "-reduced",
            "num_layers": min(self.num_layers, 2),
            "d_model": min(self.d_model, 256),
            "num_heads": min(self.num_heads, 4),
            "num_kv_heads": min(self.num_kv_heads, 2),
            "d_ff": min(self.d_ff, 512) if self.d_ff else 0,
            "vocab_size": min(self.vocab_size, 512),
            "head_dim": 64 if self.head_dim else 0,
            "attn_full_seq_max": 64,
            "attn_chunk": 16,
            "ssm_chunk": 16,
        }
        if self.num_experts:
            r.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64,
                     first_dense_layers=min(self.first_dense_layers, 1),
                     dense_d_ff=min(self.dense_d_ff, 256)
                     if self.dense_d_ff else 0)
        if self.kv_lora_rank:
            r.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
                     v_head_dim=32)
        if self.ssm_heads:
            r.update(ssm_heads=4, ssm_state=16, ssm_head_dim=32)
        if self.attn_every:
            r.update(attn_every=1, num_layers=2)
        if self.slstm_every:
            r.update(slstm_every=2, num_layers=2)
        if self.encoder_layers:
            r.update(encoder_layers=1, encoder_seq=32)
        if self.num_image_tokens:
            r.update(num_image_tokens=8)
        if self.sliding_window:
            r.update(sliding_window=32)
        return dataclasses.replace(self, **r)


class ParamTree(nn.Module):
    """A nested tree of dicts and lists of tensors as a module: one
    parameter per leaf, one submodule per inner dict or list, under the
    dict's own keys or the list's indices ("0", "1", ...).
    :meth:`tree` gives the same structure back, lists as lists."""

    def __init__(self, tree: "dict | list"):
        super().__init__()
        self._is_list = isinstance(tree, list)
        for k, v in (enumerate(tree) if self._is_list else tree.items()):
            if isinstance(v, (dict, list)):
                self.add_module(str(k), ParamTree(v))
            else:
                self.register_parameter(str(k), nn.Parameter(v))

    def _child(self, name: str):
        m = self._modules.get(name)
        return self._parameters[name] if m is None else m.tree()

    def tree(self) -> "dict | list":
        names = list(self._parameters) + list(self._modules)
        if self._is_list:
            return [self._child(str(i)) for i in range(len(names))]
        return {k: self._child(k) for k in names}


class ModelModule(nn.Module):
    """A model as a module: its parameters (a :class:`ParamTree` under the
    reference's names) and ``loss(params_tree, batch, spec)``;
    ``forward(batch)`` returns ``(loss, metrics)``."""

    def __init__(self, spec: ModelSpec, params: dict, loss):
        super().__init__()
        self.spec = spec
        self.params = ParamTree(params)
        self._loss = loss

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, batch):
        return self._loss(self.tree(), batch, self.spec)


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """This model rank's chunk of a sequence split over the model group
    (``seq_parallel`` in the full-manual train step): positions
    ``[offset, offset + length)`` of ``total``."""
    group: object
    offset: int
    length: int
    total: int

    @classmethod
    def of(cls, group, total: int) -> "SeqSplit":
        m = group.size
        if total % m:
            raise ValueError(f"seq_parallel: a sequence of {total} positions "
                             f"(image patches included) does not split "
                             f"over {m} model ranks")
        n = total // m
        return cls(group, group.rank * n, n, total)

    @property
    def rank(self) -> int:
        return self.group.rank

    def positions(self, batch: int, device) -> torch.Tensor:
        """(batch, length) int32 positions of the chunk."""
        return torch.arange(self.offset, self.offset + self.length,
                            dtype=torch.int32, device=device) \
            .expand(batch, self.length)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's chunk of ``x`` (B, length, ...) joined along the
        sequence: all-gather forward, reduce-scatter backward."""
        from ..core import manual
        return manual.seq_gather(x, 1, self.group)

    def narrow(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole-sequence ``x`` (B, total, ...)."""
        return x.narrow(1, self.offset, self.length)


def stack_layers(n: int, make) -> dict:
    """``n`` layers of ``make()`` stacked along a leading dim.  Each layer
    is drawn in turn and copied into the stacked leaves, so the stack
    never sits beside a second copy of itself (a full-depth gemma-7b is
    34 GB in f32; deepseek-v2-lite's body ``w1`` alone 19.2 GB)."""
    from .. import tree as tree_mod
    stack = None
    for i in range(n):
        layer = make()
        if stack is None:
            stack = tree_mod.tree_map(lambda x: torch.empty(
                (n,) + tuple(x.shape), dtype=x.dtype, device=x.device), layer)
        for stacked, x in zip(tree_mod.leaves(stack), tree_mod.leaves(layer)):
            stacked[i].copy_(x)
        del layer
    return stack


def layer_views(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as per-layer trees of ``unbind``
    views (whose backward writes each stacked gradient once)."""
    from .. import tree as tree_mod
    views = tree_mod.tree_map(lambda w: w.unbind(0), tree)
    return [tree_mod.tree_map(lambda ws: ws[i], views) for i in range(n)]


# ---------------------------------------------------------------------------
# initializers (seeded torch.Generator; not jax.random's bits)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """LeCun-normal over the input dimension."""
    fan_in = shape[in_axis]
    return torch.randn(shape, generator=gen, device=device) \
        / math.sqrt(fan_in)


def embed_init(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    """``x·rsqrt(mean(x²)+eps)·(1+scale)`` in f32, cast back to ``x``'s
    dtype: K6 on CUDA, its plain version on the CPU."""
    return RMSNormFn.apply(x, scale, eps)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    """The reference's LayerNorm term for term, f32 statistics: the mean,
    then ``mean((x - mu)²)``, then ``rsqrt(var + eps)`` (not
    ``F.layer_norm``, whose Welford statistics round otherwise); plain
    torch, as the reference computes it outside any kernel."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params.get("bias"))
    raise ValueError(f"unknown norm {kind!r}")


def norm_params(d: int, kind: str, device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(dim: int, theta: float, device: torch.device):
    """:func:`rope_frequencies` on ``device``, copied there once: a copy
    from pageable host memory waits for the device's stream, so one per
    attention layer would hold the host at every layer (and, behind a
    ``cuda_ipc`` wait on the card, past the channel's deadline)."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_frequencies(dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dim = x.shape[-1]
    freqs = _rope_frequencies_on(dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, start: int = 0) -> np.ndarray:
    """``(seq - start, dim)`` f32 ``[sin | cos]`` of ``pos /
    10000^(2i/dim)`` for positions ``start .. seq - 1``, computed in
    numpy as the reference does (each row alike whatever ``start``)."""
    pos = np.arange(start, seq, dtype=np.float32)[:, None]
    i = np.arange(dim // 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

class _TokenNLL(torch.autograd.Function):
    """``logsumexp(x) - x[label]`` per token in f32, with the gradient
    autograd gives the composite (``exp(x - lse) * g``, and ``-g`` added
    at each label), but leaner: it keeps the logits as given (bf16 at
    half the f32 bytes) rather than their f32 copy, and builds the
    gradient in one f32 buffer, where the composite's backward holds
    three or four of them at once.  At a 256000-word vocabulary and 4096
    tokens each such buffer is 4.2 GB."""

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.to(torch.float32)
        lse = torch.logsumexp(x, dim=-1)
        ll = torch.gather(x, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True)
        grad.sub_(lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, labels[..., None], -g[..., None])
        return grad.to(logits.dtype), None


def cross_entropy(logits, labels, mask=None, count=None):
    """Token-mean CE; logits (..., V) any dtype, stats in fp32.  With
    ``count`` the (masked) sum over these tokens divided by ``count``:
    a sequence chunk's share of the whole sequence's mean."""
    nll = _TokenNLL.apply(logits, labels.long())
    if count is not None:
        if mask is not None:
            nll = nll * mask.to(torch.float32)
        return torch.sum(nll) / count
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
