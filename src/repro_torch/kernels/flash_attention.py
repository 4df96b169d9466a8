"""Flash attention on Hopper: forward (K7) and FlashAttention-2 backward
(K8).

Counterpart of ``repro/kernels/flash_attention.py``.  The kernels of
``csrc/flash_attention.cu`` replace the Pallas ``_flash_fwd_kernel``
(K7) and ``_flash_dq_kernel`` + ``_flash_dkv_kernel`` (K8, two
kernels: a dq pass over query tiles and a dk/dv pass over key tiles,
each output tile owned by one thread block, so no atomics and two calls
give the same bits).  Both are bound by tensor-core operations
(``4·B·H·S²·dh·½`` causal forward, ``8·B·H·S²·dh·½`` for the backward's
four products; its two passes do seven).  Tiles wholly above the
diagonal or outside the window are skipped.

bfloat16 runs on the tensor cores: ``wgmma`` with bf16 operands and f32
accumulators, P and dS fed from registers rounded to bf16, K/V (Q/dO in
the dk/dv pass) streamed by TMA through a two-stage ring by one thread
of a producer warpgroup, two consumer warpgroups of 64 rows per block
(at ``dh`` 96, and in the forward at 256, each product that accumulates
over the head width is one ``wgmma`` across it, and the forward streams
K and V into slots of their own).
TMA needs every pointer 16-byte aligned, which the wrapper checks.  The
head widths are ``HEAD_DIMS``; TMA and ``wgmma`` read a bf16 row in
swizzle boxes of 64, 32 or 16 columns, the widest that divides it (three
of 32 at ``dh`` 96, phi-3-vision's).  At
``dh`` 256 (gemma-7b) the backward has kernels of its own, to fit the
block's shared memory and registers: a block owns 64 rows, the two
consumer warpgroups split each streamed tile's score products by
columns, exchange their halves of P and dS through shared memory, and
each accumulates half of the head dimension.  float32 stays on the CUDA
cores (64×64 f32 tiles, 32×32 in the backward at ``dh`` 256): the
tensor cores take f32 only as TF32.

Shapes: ``q`` is ``(B, Sq, H, dh)`` and ``k, v`` ``(B, Sk, H, dh)``,
with the kv heads already repeated to ``H``; ``lse`` is ``(B, H, Sq)``
f32.  Query row ``i`` stands at position ``q_offset + i`` and key row
``j`` at ``j`` (the square case: ``Sq = Sk``, ``q_offset = 0``; a
sequence split over the model ranks gives each rank its chunk of
queries against every key); a key is visible to a query when ``k <= q``
(``causal``) and ``q - k < window`` (``window > 0``), in positions.  Any
``Sq`` and ``Sk`` are taken: keys past the end are masked and rows past
the end are not written.

Beside the kernels live :func:`flash_fwd_plain` and
:func:`flash_bwd_plain`, torch transcriptions of the reference's chunked
``_flash_fwd_impl`` / ``_flash_bwd`` (``repro/models/attention.py``):
chunked by ``chunk`` (the model's ``attn_chunk``), scores in the input
dtype and then f32, masked with the finite ``NEG_INF``.  The kernels
take their scores in f32 from the inputs' exact products, as the Pallas
kernel does, and in bf16 round P and dS to bf16 before their products,
so in bf16 the two round differently (tolerances in the tests).  The
wrappers take the plain versions only for CPU tensors; for CUDA tensors
they launch the kernels or raise.  :class:`FlashAttnFn` joins forward
and backward for autograd.

On CUDA ``rowsum(dO∘O)`` is a kernel too (:func:`_delta_launch`; the
reference's einsum before its two ``pallas_call``s, 16-byte vector
loads, products and sums in f32), which moves K8's outputs in the last
bits against the plain einsum's :func:`_delta`.

``flash_attention_fwd.launches`` counts K7 launches;
``flash_attention_bwd.launches`` counts K8 calls (one per call, though
each call launches its three kernels); ``.offset_launches`` counts, of
those, the ones with a query offset or ``Sq != Sk`` (the kernels' other
build).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import backend

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(dh: int) -> float:
    """``1/sqrt(dh)`` as the f32 the reference multiplies by."""
    return float(np.float32(1.0 / np.sqrt(dh)))


# ---------------------------------------------------------------------------
# Plain versions (CPU path, tests, and the card-side comparison)
# ---------------------------------------------------------------------------

def _bias(q0: int, k0: int, chunk: int, sq: int, sk: int, causal: bool,
          window: int, device, q_offset: int = 0) -> torch.Tensor:
    """(chunk, chunk) additive f32 mask of one (query rows, key rows)
    chunk pair; query row ``i`` at position ``q_offset + i``."""
    qp = torch.arange(q0, q0 + chunk, device=device)[:, None]
    kp = torch.arange(k0, k0 + chunk, device=device)[None, :]
    m = (qp < sq) & (kp < sk)
    qp = qp + q_offset
    if causal:
        m = m & (qp >= kp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1])) if n > x.shape[1] \
        else x


def _chunks(x: torch.Tensor, chunk: int):
    return [x[:, i:i + chunk] for i in range(0, x.shape[1], chunk)]


def flash_fwd_plain(q, k, v, causal: bool = True, window: int = 0,
                    chunk: int = 64, q_offset: int = 0):
    """``(out (B,Sq,H,dh) in q's dtype, lse (B,H,Sq) f32)``: the
    reference's ``_flash_fwd_impl`` over ``chunk``-sized blocks."""
    b, s, h, dh = q.shape
    sk = k.shape[1]
    sp = -(-s // chunk) * chunk
    qs = _chunks(_pad_seq(q, sp), chunk)
    ks = _chunks(_pad_seq(k, -(-sk // chunk) * chunk), chunk)
    vs = _chunks(_pad_seq(v, -(-sk // chunk) * chunk), chunk)
    scale = _scale(dh)
    outs, lses = [], []
    for i, qb in enumerate(qs):
        acc = torch.zeros((b, h, chunk, dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk), dtype=torch.float32, device=q.device)
        for j, (kb, vb) in enumerate(zip(ks, vs)):
            sc = torch.einsum("bqhd,bkhd->bhqk", qb, kb).to(torch.float32)
            sc = sc * scale + _bias(i * chunk, j * chunk, chunk, s, sk,
                                    causal, window, q.device, q_offset)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb.to(torch.float32))
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype).transpose(1, 2))
        lses.append(m + torch.log(l_safe))
    out = torch.cat(outs, dim=1)[:, :s].contiguous()
    lse = torch.cat(lses, dim=-1)[..., :s].contiguous()
    return out, lse


def _delta(out, dout) -> torch.Tensor:
    """``rowsum(dO∘O)`` as ``(B, H, S)`` f32, the reference's einsum:
    the plain version of K8's delta kernel (:func:`_delta_launch`)."""
    return torch.einsum("bshd,bshd->bhs", dout.to(torch.float32),
                        out.to(torch.float32)).contiguous()


def delta_tolerance(out, dout) -> torch.Tensor:
    """``dh·2⁻²⁴·Σ|dO∘O|`` per row as ``(B, H, S)`` f32: the f32
    summation bound within which ``rowsum(dO∘O)`` summed in any order
    (the kernel's, ``_delta``'s) lies of the exact sum."""
    return torch.einsum("bshd,bshd->bhs", dout.to(torch.float32).abs(),
                        out.to(torch.float32).abs()) * (out.shape[-1]
                                                        * 2.0 ** -24)


def flash_bwd_plain(q, k, v, out, lse, dout, causal: bool = True,
                    window: int = 0, chunk: int = 64, q_offset: int = 0):
    """``(dq, dk, dv)``: the reference's ``_flash_bwd`` (a dq pass over
    query chunks, then a dk/dv pass over key chunks)."""
    b, s, h, dh = q.shape
    sk = k.shape[1]
    sp = -(-s // chunk) * chunk
    skp = -(-sk // chunk) * chunk
    scale = _scale(dh)
    delta = F.pad(_delta(out, dout), (0, sp - s))
    lse = F.pad(lse, (0, sp - s))
    qs = _chunks(_pad_seq(q, sp), chunk)
    dos = _chunks(_pad_seq(dout, sp), chunk)
    ks = _chunks(_pad_seq(k, skp), chunk)
    vs = _chunks(_pad_seq(v, skp), chunk)
    lses = [lse[..., i:i + chunk] for i in range(0, sp, chunk)]
    deltas = [delta[..., i:i + chunk] for i in range(0, sp, chunk)]

    def probs(i, j):
        sc = torch.einsum("bqhd,bkhd->bhqk", qs[i], ks[j]).to(torch.float32)
        sc = sc * scale + _bias(i * chunk, j * chunk, chunk, s, sk, causal,
                                window, q.device, q_offset)
        p = torch.exp(sc - lses[i][..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dos[i].to(torch.float32),
                          vs[j].to(torch.float32))
        return p, p * (dp - deltas[i][..., None]) * scale

    dqs = []
    for i in range(len(qs)):
        dq = torch.zeros((b, chunk, h, dh), dtype=torch.float32,
                         device=q.device)
        for j in range(len(ks)):
            _, ds = probs(i, j)
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds,
                                   ks[j].to(torch.float32))
        dqs.append(dq)
    dks, dvs = [], []
    for j in range(len(ks)):
        dk = torch.zeros((b, chunk, h, dh), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros_like(dk)
        for i in range(len(qs)):
            p, ds = probs(i, j)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p,
                                   dos[i].to(torch.float32))
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds,
                                   qs[i].to(torch.float32))
        dks.append(dk)
        dvs.append(dv)

    def join(parts, like):
        return torch.cat(parts, dim=1)[:, :like.shape[1]].to(like.dtype) \
            .contiguous()
    return join(dqs, q), join(dks, k), join(dvs, v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    lib = backend.load("flash_attention")
    if not getattr(lib, "_typed", False):
        ints = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
        lib.flash_attention_fwd.argtypes = [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 9 + ints + [ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_tc_smem.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_tc_smem.restype = ctypes.c_int
        lib.flash_attention_delta.argtypes = [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flash_attention_delta.restype = ctypes.c_int
        lib._typed = True
    return lib


def _on_cpu(what: str, *tensors) -> bool:
    """True for host tensors (and meta ones, which the dry run counts
    through the plain versions' arithmetic); False for CUDA tensors."""
    devs = {t.device.type for t in tensors}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs != {"cuda"}:
        raise ValueError(f"{what}: unsupported/mixed devices {devs}")
    return False


def _check_kernel_inputs(what: str, q, *same, f32=(), keys=()):
    """``q`` and ``same`` (B, Sq, H, dh), ``keys`` (B, Sk, H, dh), ``f32``
    (B, H, Sq)."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, S, H, dh), got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    for t in same:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{what}: every (B, Sq, H, dh) input must "
                             f"match q's shape and dtype")
    for t in keys:
        if t.dim() != 4 or t.shape[0] != q.shape[0] \
                or t.shape[2:] != q.shape[2:] or t.dtype != q.dtype \
                or t.shape != keys[0].shape:
            raise ValueError(f"{what}: k and v must be (B, Sk, H, dh) "
                             f"with q's B, H, dh and dtype")
    b, s, h, _ = q.shape
    for t in f32:
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s):
            raise ValueError(f"{what}: lse/delta must be float32 "
                             f"({b}, {h}, {s})")
    backend.check_cuda(what, q, *same, *keys, *f32)
    if q.dtype == torch.bfloat16:
        # TMA's rule for the (B, S, H, dh) inputs: base and row stride
        # 16-byte aligned.
        for t in (q, *same, *keys):
            if t.data_ptr() % 16 or t.shape[2] * t.shape[3] * 2 % 16:
                raise ValueError(f"{what}: bfloat16 inputs must start on "
                                 f"a 16-byte boundary (TMA)")


def _offset(q_offset) -> int:
    if int(q_offset) < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return int(q_offset)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        chunk: int = 64, q_offset: int = 0):
    """``(out, lse)``.  ``chunk`` sets the plain version's blocks (CPU);
    the kernels tile by 64 (f32) or 128 queries by 64 keys (bf16)."""
    q_offset = _offset(q_offset)
    if _on_cpu("flash_attention_fwd", q, k, v):
        return flash_fwd_plain(q, k, v, causal, window, chunk, q_offset)
    _check_kernel_inputs("flash_attention_fwd", q, keys=(k, v))
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    backend.check(_lib().flash_attention_fwd(
        _DTYPE_CODE[q.dtype], dh, *(backend.ptr(t) for t in (q, k, v, out,
                                                              lse)),
        b, s, k.shape[1], q_offset, h, _scale(dh), int(causal), int(window),
        backend.stream_ptr()), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.offset_launches += q_offset > 0 or k.shape[1] != s
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.offset_launches = 0


def _bwd_launch(q, k, v, dout, lse, delta, causal, window, passes=3,
                q_offset=0):
    """K8's kernels on checked CUDA inputs: ``passes`` 3 launches both,
    1 the dq pass alone, 2 the dk/dv pass alone (the outputs the other
    pass would write are left unset).  Counts nothing."""
    b, s, h, dh = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    backend.check(_lib().flash_attention_bwd(
        _DTYPE_CODE[q.dtype], dh,
        *(backend.ptr(t) for t in (q, k, v, dout, lse, delta, dq, dk, dv)),
        b, s, k.shape[1], int(q_offset), h, _scale(dh), int(causal),
        int(window), passes, backend.stream_ptr()), "flash_attention_bwd")
    return dq, dk, dv


def _delta_launch(out, dout) -> torch.Tensor:
    """``rowsum(dO∘O)`` as ``(B, H, S)`` f32 by K8's delta kernel, on
    checked CUDA inputs (:func:`_delta` is its plain version).  Counts
    nothing."""
    b, s, h, dh = out.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=out.device)
    backend.check(_lib().flash_attention_delta(
        _DTYPE_CODE[out.dtype], dh, *(backend.ptr(t) for t in (out, dout,
                                                                delta)),
        b, s, h, int(backend.vector_aligned(out, dout)),
        backend.stream_ptr()), "flash_attention_delta")
    return delta


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, chunk: int = 64, q_offset: int = 0):
    """``(dq, dk, dv)`` in the inputs' dtype.  On CUDA three kernels:
    ``rowsum(dO∘O)``, the dq pass and the dk/dv pass."""
    q_offset = _offset(q_offset)
    if _on_cpu("flash_attention_bwd", q, k, v, out, lse, dout):
        return flash_bwd_plain(q, k, v, out, lse, dout, causal, window,
                               chunk, q_offset)
    _check_kernel_inputs("flash_attention_bwd", q, out, dout, f32=(lse,),
                         keys=(k, v))
    delta = _delta_launch(out, dout)
    grads = _bwd_launch(q, k, v, dout, lse, delta, causal, window,
                        q_offset=q_offset)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.offset_launches += q_offset > 0 \
        or k.shape[1] != q.shape[1]
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.offset_launches = 0


class FlashAttnFn(torch.autograd.Function):
    """Attention through K7 forward and K8 backward on CUDA, or the plain
    versions on the CPU.  ``apply(q, k, v, causal, window, chunk,
    q_offset=0)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset=0):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, chunk=chunk,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = {"causal": causal, "window": window, "chunk": chunk,
                   "q_offset": q_offset}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.cfg)
        return dq, dk, dv, None, None, None, None

