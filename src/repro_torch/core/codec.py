"""Per-stage wire codecs for the ReduceSchedule IR.

Counterpart of ``repro/core/codec.py`` (see its docstring for the design
and the derived tolerance bounds, which this module keeps unchanged).
Each coded stage encodes the payload immediately before every
``ppermute`` hop and decodes it immediately after, so accumulation stays
in float32 while the wire carries 1-2 bytes per element:

``none``       pass-through
``bf16``       truncate to bfloat16 for the hop (2 bytes/elem, no scale)
``int8``       ``q = round(x/s)``, ``s = absmax/127`` (+ one f32 scale)
``fp8_e4m3``   ``x/s`` cast to ``float8_e4m3fn``, ``s = absmax/448``

Payloads travel as their raw bytes (the transport views every part as
``torch.uint8``, ``core/dist.py``): the process group moves opaque
bytes, so nothing can convert them on the way — the reference's XLA
bitcast pinning has no counterpart to keep.

``encode``/``decode`` are the plain torch arithmetic of the fused-hop
kernels (``kernels/fused_hop.py``); the ``fused`` permuter runs the
kernels themselves.

Coded forwarding hops (no accumulate) also hand back the value their
receivers decode — see :func:`permuter` — so the rank that sent a
reduced chunk can keep exactly what its peers hold (the reference keeps
the owner's unquantized copy, and data-parallel replicas drift apart by
a quantum).  A forwarding hop whose payload joins blocks that were each
decoded at their own scale (RHD's all-gather and post-fold hops) ships
each block at its own scale (``blocks=``), so re-encoding what a rank
kept gives back the same bits instead of a coarser joint quantization.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import fused_hop
from . import dist as dist_mod

# Algorithms whose hops are explicit ppermutes we can encode around.
CODED_ALGORITHMS = ("ring_rsa", "rhd_rsa")

# f32 scale scalar shipped per hop for absmax-scaled codecs.
SCALE_BYTES = 4

CODEC_EPS = {
    "bf16": 2.0 ** -8,
    "fp8_e4m3": 2.0 ** -3,
    "int8": 1.0 / 254.0,
}


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire codec: identity + closed-form byte accounting."""
    name: str
    itemsize: int          # encoded bytes per element on the wire
    scaled: bool           # ships a per-hop f32 absmax scale scalar
    short: str             # render() suffix

    @property
    def hop_overhead_bytes(self) -> int:
        return SCALE_BYTES if self.scaled else 0


_REGISTRY = {
    "none": Codec("none", itemsize=0, scaled=False, short=""),
    "bf16": Codec("bf16", itemsize=2, scaled=False, short="bf16"),
    "int8": Codec("int8", itemsize=1, scaled=True, short="int8"),
    "fp8_e4m3": Codec("fp8_e4m3", itemsize=1, scaled=True, short="fp8"),
}

CODECS = tuple(_REGISTRY)


def get(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown wire codec {name!r}; one of {CODECS}")


# ---------------------------------------------------------------------------
# Codec specs: "<codec>" for every level, "<inner>×<outer>" per level
# ---------------------------------------------------------------------------

SPEC_SEP = "×"


def split_spec(spec: str, n_levels: int) -> tuple[str, ...]:
    """Per-level codec names from a spec string.  A bare codec name
    applies to every level; ``"<inner>×<outer>"`` (ASCII ``x``
    accepted) gives the two levels of a two-axis schedule, inner (the
    data axis) first, as the ``"<inner>×<outer>"`` strategy names do."""
    spec = spec or "none"
    if spec in _REGISTRY:
        return (spec,) * n_levels
    parts = tuple(spec.replace("x", SPEC_SEP).split(SPEC_SEP))
    for p in parts:
        if p not in _REGISTRY:
            raise ValueError(f"unknown wire codec {p!r} in spec "
                             f"{spec!r}; names from {CODECS}")
    if len(parts) != n_levels:
        raise ValueError(f"codec spec {spec!r} has {len(parts)} level(s) "
                         f"but the schedule has {n_levels}")
    return parts


def validate_spec(spec: str) -> None:
    """Raise ValueError unless ``spec`` is a bare codec name or a
    two-level ``"<inner>×<outer>"`` composition of codec names."""
    spec = spec or "none"
    if spec in _REGISTRY:
        return
    parts = tuple(spec.replace("x", SPEC_SEP).split(SPEC_SEP))
    if len(parts) != 2:
        raise ValueError(f"codec spec {spec!r} must be a codec name "
                         f"{CODECS} or '<inner>{SPEC_SEP}<outer>'")
    for p in parts:
        if p not in _REGISTRY:
            raise ValueError(f"unknown wire codec {p!r} in spec "
                             f"{spec!r}; names from {CODECS}")


def stage_codec(name: str, algorithm: str) -> str:
    """Vendor collectives expose no ppermute hop, so they carry none."""
    if name == "none" or algorithm in CODED_ALGORITHMS:
        return name
    return "none"


# ---------------------------------------------------------------------------
# Closed-form byte accounting
# ---------------------------------------------------------------------------

def encoded_bytes(name: str, n_bytes: int, wire_itemsize: int) -> int:
    c = get(name)
    if c.name == "none":
        return int(n_bytes)
    return (int(n_bytes) // int(wire_itemsize)) * c.itemsize


def hop_bytes(name: str, n_hops: int) -> int:
    return get(name).hop_overhead_bytes * int(n_hops)


# ---------------------------------------------------------------------------
# Derived tolerance bounds (relative to the bucket's input absmax)
# ---------------------------------------------------------------------------

def tolerance(name: str, p: int, hops: int | None = None) -> float | None:
    """``hops · eps`` (times ``p`` for int8); ``hops`` defaults to the
    ring's ``2(p-1)``.  ``none`` is 0.0; unknown codecs None."""
    if name == "none":
        return 0.0
    eps = CODEC_EPS.get(name)
    if eps is None:
        return None
    p = max(int(p), 1)
    depth = float(2 * (p - 1) if hops is None else hops)
    if name == "int8":
        return depth * p * eps
    return depth * eps


# ---------------------------------------------------------------------------
# Execution: encode / decode / coded ppermute
# ---------------------------------------------------------------------------

def encode(name: str, x: torch.Tensor):
    """``(payload, scale)``; ``scale`` is None for unscaled codecs."""
    get(name)
    return fused_hop.encode_plain(name, x)


def decode(name: str, payload: torch.Tensor, scale) -> torch.Tensor:
    """Back to float32 (the accumulation dtype)."""
    get(name)
    return fused_hop.decode_add_plain(name, payload, scale)


def roundtrip(name: str, x: torch.Tensor) -> torch.Tensor:
    payload, scale = encode(name, x)
    return decode(name, payload, scale)


def _wire(payload, scale, group, perm, consume):
    """Ship ``payload`` and ``scale`` (None, or a 1-d f32 tensor of one
    scale per block) beside it, and return ``consume(received payload,
    received scales)``.  On gloo the two go as two ppermutes; on
    cuda_ipc the scales ride in their payload's slot (one handshake)
    and ``consume`` reads the slot in place."""
    parts = [payload.reshape(-1)]
    if scale is not None:
        parts.append(scale.reshape(-1))

    def unpack(recv, rscale=None):
        return consume(recv.reshape(payload.shape), rscale)

    return dist_mod.ppermute_parts(parts, group, perm, consume=unpack)


def permuter(name: str, fused: bool = False):
    """A drop-in replacement for ``dist.ppermute`` that encodes the
    payload for the hop and decodes on receipt.

    Coded permuters take the hop protocol ``hop(x, group, perm,
    add=None, keep_sent=False, blocks=1)`` (``supports_add``): with
    ``add`` the decode accumulates onto it, and ``keep_sent=True``
    returns ``(received, sent)`` where ``sent`` is this rank's own
    payload decoded — the value its receivers hold.  ``blocks > 1``
    splits ``x`` along dim 0 into that many equal blocks and gives each
    a scale of its own (the encode and decode run once per block on
    views; unscaled codecs ignore it): a block that was decoded at
    scale ``s`` is re-encoded at ``s`` again, bit for bit.

    ``fused=True`` runs the encode and the decode(+accumulate) as single
    kernel passes (``kernels/fused_hop.py``) instead of staged torch ops;
    the wire payload and scale are identical."""
    c = get(name)
    if c.name == "none" and not fused:
        return dist_mod.ppermute
    enc = fused_hop.hop_encode if fused else encode
    dec = fused_hop.hop_decode_add if fused \
        else fused_hop.decode_add_plain

    def encode_blocks(x, blocks):
        if blocks == 1:
            payload, scale = enc(c.name, x)
            return payload, None if scale is None else scale.reshape(1)
        coded = [enc(c.name, b) for b in x.reshape(blocks, -1).unbind(0)]
        return (torch.stack([q for q, _ in coded]).reshape(x.shape),
                torch.stack([s for _, s in coded]))

    def decode_blocks(payload, scales, add):
        if scales is None or scales.numel() == 1:
            return dec(c.name, payload, None if scales is None
                       else scales[0], add)
        n = scales.numel()
        adds = [None] * n if add is None else add.reshape(n, -1).unbind(0)
        return torch.stack([
            dec(c.name, q, s, a) for q, s, a in
            zip(payload.reshape(n, -1).unbind(0), scales.unbind(0), adds)
        ]).reshape(payload.shape)

    def coded_ppermute(x, group, perm, add=None, keep_sent=False,
                       blocks=1):
        if c.name == "none":
            recv = dist_mod.ppermute(x, group, perm)
            out = recv if add is None else dec("none", recv, None, add)
            return (out, x) if keep_sent else out
        payload, scales = encode_blocks(x, int(blocks) if c.scaled else 1)
        out = _wire(payload, scales, group, perm,
                    lambda recv, rscales: decode_blocks(recv, rscales, add))
        if keep_sent:
            return out, decode_blocks(payload, scales, None)
        return out

    coded_ppermute.supports_add = True
    return coded_ppermute


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------

def ef_quantize(name: str, x: torch.Tensor, residual: torch.Tensor):
    """``(q(x + r), (x + r) - q(x + r))`` — the telescoping residual."""
    z = x.to(torch.float32) + residual.to(torch.float32)
    dq = roundtrip(name, z)
    return dq, z - dq
