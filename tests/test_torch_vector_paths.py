"""The inputs that pick K2's, K5's and K6's paths, on the CPU.

On the card ``hop_encode`` (K2) and ``adamw_update`` (K5) move 16-byte
vectors when their buffers start on a 16-byte boundary and take their
kernels' scalar loops otherwise; small n leaves a ragged tail.  The
choice is ``backend.vector_aligned``, a pure test on ``data_ptr()``,
held here on views at every storage offset.  On the CPU both wrappers
run their plain versions, so these tests pin the plain side of each
card comparison to the JAX reference on the inputs that reach each
path: views 4, 8 and 12 bytes into a 1 Mi buffer, n of 1 to 33, and
K5 in place with a misaligned ``g``.  K2 must be bit-exact with
``repro.core.codec.encode`` and ``repro.kernels.fused_hop.hop_encode``;
K5 within 1 ulp of ``repro.kernels.ref.adamw_update_ref`` (and bit-exact
with the port's own ``ref.py``).  K6 (``fused_rmsnorm``) takes 16-byte
vectors when ``x``, ``y`` and ``scale`` are aligned and ``d`` is a
multiple of the vector width, and its scalar loop otherwise: its plain
side is held to ``repro.models.common.rmsnorm`` (rtol 1e-5 in f32, one
bf16 ulp) at one row, at widths 1000, 1001 and 7, and on views one
element into their storage.  The kernels meet these inputs in
tests/test_torch_kernels_on_card.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import codec as jcodec
from repro.kernels import fused_hop as jfh
from repro.kernels import ref as jref

from repro_torch.convert import tensor_to_numpy
from repro_torch.kernels import backend
from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels import fused_hop as fh
from repro_torch.kernels import fused_rmsnorm as frn
from repro_torch.kernels import ref as tref

CODED = ("bf16", "int8", "fp8_e4m3")
BIG_N = 1 << 20
SMALL_N = (1, 3, 4, 5, 7, 8, 15, 16, 17, 31, 33)
OFFSETS = (1, 2, 3)


def _storage(n, dtype=torch.float32):
    """A fresh torch buffer; the CPU allocator aligns it to 64 bytes."""
    buf = torch.zeros(n, dtype=dtype)
    assert buf.data_ptr() % 64 == 0
    return buf


@pytest.mark.parametrize("offset", range(8))
def test_vector_aligned_at_each_f32_offset(offset):
    view = _storage(64)[offset:]
    assert backend.vector_aligned(view) == (offset % 4 == 0)
    assert backend.vector_aligned(view, width=8) == (offset % 2 == 0)
    assert backend.vector_aligned(view, width=4)


@pytest.mark.parametrize("f32_off,bf16_off,i8_off,want", [
    (0, 0, 0, True), (4, 8, 16, True), (4, 8, 0, True),
    (1, 0, 0, False), (0, 4, 0, False), (0, 0, 8, False),
    (4, 8, 15, False), (3, 7, 15, False)])
def test_vector_aligned_on_mixed_tuples(f32_off, bf16_off, i8_off, want):
    """Every tensor must be aligned, whatever its element size; None
    (a bf16 hop's absent scale) is skipped."""
    views = (_storage(64)[f32_off:], None,
             _storage(64, torch.bfloat16)[bf16_off:],
             _storage(64, torch.int8)[i8_off:])
    assert backend.vector_aligned(*views) == want
    assert backend.vector_aligned() and backend.vector_aligned(None)


def _outlier_buffer(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.integers(0, n)] = 1e4
    return x


def _same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(np.asarray(b))
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _check_encode(name, x_np, x_t):
    """K2 on the CPU: the plain version, no launch, bit-exact with the
    reference's codec and fused hop."""
    counts = (fh.hop_encode.launches, fh.hop_encode.scalar_launches)
    tp, ts = fh.hop_encode(name, x_t)
    assert (fh.hop_encode.launches, fh.hop_encode.scalar_launches) == counts
    for jp, js in (jcodec.encode(name, jnp.asarray(x_np)),
                   jfh.hop_encode(name, jnp.asarray(x_np))):
        assert _same_bits(tensor_to_numpy(tp), jp), name
        if js is None:
            assert ts is None
        else:
            assert _same_bits(tensor_to_numpy(ts), js), name


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("name", CODED)
def test_encode_on_misaligned_views_matches_reference(name, offset):
    x = _outlier_buffer(BIG_N, seed=offset)
    buf = _storage(BIG_N)
    buf.copy_(torch.from_numpy(x))
    view = buf[offset:]
    assert not backend.vector_aligned(view)
    _check_encode(name, x[offset:], view)


@pytest.mark.parametrize("n", SMALL_N)
@pytest.mark.parametrize("name", CODED)
def test_encode_at_small_n_matches_reference(name, n):
    x = _outlier_buffer(n, seed=n)
    _check_encode(name, x, torch.from_numpy(x))


def test_bf16_special_values_match_reference():
    """+-inf, -0, overflow to inf, subnormals and ties: the plain cast is
    the reference's astype bit for bit (NaN is checked on the card,
    where the kernel writes 0x7fc0)."""
    x = np.array([np.inf, -np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 1e-40,
                  -1e-40, 1.00390625, 1.01171875, -2.5], np.float32)
    _check_encode("bf16", x, torch.from_numpy(x))


def _ulp_distance(a, b) -> int:
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.max(np.abs(ordered(a) - ordered(b))))


def _adam_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) * 0.05).astype(np.float32),
            (rng.standard_normal(n) * 1e-3).astype(np.float32),
            (rng.standard_normal(n) * 1e-4).astype(np.float32),
            (rng.standard_normal(n) ** 2 * 1e-6).astype(np.float32))


KW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, count=3)


def _check_adamw(arrays, tensors, inplace=False):
    """K5 on the CPU: the plain version, no launch, within 1 ulp of the
    reference and bit-exact with the port's ref.py."""
    want = jref.adamw_update_ref(*(jnp.asarray(a) for a in arrays), **KW)
    plain = tref.adamw_update_ref(*(torch.from_numpy(a.copy())
                                    for a in arrays), **KW)
    counts = (fa.adamw_update.launches, fa.adamw_update.scalar_launches)
    got = fa.adamw_update(*tensors, inplace=inplace, **KW)
    assert (fa.adamw_update.launches,
            fa.adamw_update.scalar_launches) == counts
    if inplace:
        p, _, m, v = tensors
        assert got[0] is p and got[1] is m and got[2] is v
    for gt, wt, pt in zip(got, want, plain):
        assert _ulp_distance(tensor_to_numpy(gt), wt) <= 1
        assert torch.equal(gt, pt)


def _views(arrays, offset):
    out = []
    for a in arrays:
        buf = _storage(a.size + offset)
        buf[offset:].copy_(torch.from_numpy(a))
        out.append(buf[offset:])
    return out


@pytest.mark.parametrize("offset", OFFSETS)
def test_adamw_on_misaligned_views_matches_reference(offset):
    arrays = _adam_inputs(BIG_N - offset, seed=offset)
    views = _views(arrays, offset)
    assert not backend.vector_aligned(*views)
    _check_adamw(arrays, views)


@pytest.mark.parametrize("n", SMALL_N)
def test_adamw_at_small_n_matches_reference(n):
    arrays = _adam_inputs(n, seed=n)
    _check_adamw(arrays, [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("offset", OFFSETS)
def test_adamw_in_place_with_misaligned_g_matches_reference(offset):
    """The optimizer's call (in place) with ``g`` a view into a flat
    buffer at an offset the vector path cannot take."""
    arrays = _adam_inputs(4099, seed=10 + offset)
    p, m, v = (torch.from_numpy(a.copy()) for a in (arrays[0], arrays[2],
                                                     arrays[3]))
    (g,) = _views(arrays[1:2], offset)
    assert backend.vector_aligned(p, m, v)
    assert not backend.vector_aligned(p, g, m, v)
    _check_adamw(arrays, (p, g, m, v), inplace=True)


def _bf16_ulp(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,offset", [
    (1, 960, 0), (1, 3072, 0), (5, 1000, 0), (5, 1001, 0), (5, 7, 0),
    (5, 960, 1), (1, 3072, 1)])
def test_rmsnorm_inputs_of_every_path_match_reference(rows, d, offset,
                                                      dtype):
    """K6 on the CPU (its plain version, no launch) on the inputs that
    reach each of the kernel's paths: the reference's rmsnorm within
    rtol 1e-5 (f32) or one bf16 ulp, bit-exact with the port's
    ``ref.py``, and ``vector_aligned`` false exactly for the views."""
    from repro.models.common import rmsnorm as jrmsnorm
    from repro_torch.convert import tensor_from_numpy
    rng = np.random.default_rng(rows * d + offset)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (rng.standard_normal(d) * 0.1).astype(np.float32)
    tdtype = getattr(torch, dtype)
    buf = _storage(rows * d + offset, tdtype)
    buf[offset:].copy_(torch.from_numpy(x).reshape(-1).to(tdtype))
    view = buf[offset:].view(rows, d)
    assert backend.vector_aligned(view) == (offset == 0)
    counts = (frn.fused_rmsnorm.launches, frn.fused_rmsnorm.scalar_launches)
    got, rstd = frn.fused_rmsnorm(view, torch.from_numpy(s))
    assert (frn.fused_rmsnorm.launches,
            frn.fused_rmsnorm.scalar_launches) == counts
    assert got.dtype == tdtype and rstd.shape == (rows,)
    want = jrmsnorm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(s))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=0)
    else:
        assert _bf16_ulp(got, tensor_from_numpy(np.asarray(want))) <= 1
    assert torch.equal(tref.rmsnorm_ref(view, torch.from_numpy(s)), got)
