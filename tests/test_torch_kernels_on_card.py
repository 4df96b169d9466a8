"""The CUDA kernels against their plain torch versions, on the card.

Imports neither jax nor the reference, so it runs on a machine that has
only PyTorch for CUDA:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_on_card.py

Without a card every test skips (decided in the ``cuda`` fixture, when a
test runs).  K1/K2/K3 and K4 must be bit-exact; K5 within 1 ulp; K6, K7
and K8 within the tolerances their tests state.  K2 and K5 are held on
every path: 16-byte vectors, the ragged tail, and the scalar loop that
views off a 16-byte boundary take (counted in ``scalar_launches``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fla
from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels import fused_hop as fh
from repro_torch.kernels import fused_rmsnorm as frn
from repro_torch.kernels.fused_reduce import fused_reduce, fused_reduce_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(n, seed, outlier=False):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if outlier:
        x[n // 3] = 1e4
    return torch.from_numpy(x)


def _ulp_distance(a, b) -> int:
    def ordered(t):
        i = t.detach().cpu().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8_e4m3"])
def test_hop_kernels_match_plain_on_card(cuda, name):
    x = _normal(1 << 16, 1, outlier=True).to(cuda)
    add = _normal(1 << 16, 2).to(cuda)
    p, s = fh.hop_encode(name, x)
    pp, sp = fh.encode_plain(name, x)
    assert torch.equal(p.view(torch.uint8), pp.view(torch.uint8))
    assert (s is None and sp is None) or torch.equal(s, sp)
    for a in (add, None):
        assert torch.equal(fh.hop_decode_add(name, p, s, a),
                           fh.decode_add_plain(name, p, s, a))
    assert torch.equal(fh.hop_absmax(x), fh.absmax_plain(x))


def test_adamw_kernel_matches_plain_on_card(cuda):
    p = (_normal(1 << 16, 3) * 0.05).to(cuda)
    g = (_normal(1 << 16, 4) * 1e-3).to(cuda)
    m = (_normal(1 << 16, 5) * 1e-4).to(cuda)
    v = (_normal(1 << 16, 6) ** 2 * 1e-6).to(cuda)
    kw = dict(lr=1e-3, count=2)
    for a, b in zip(fa.adamw_update(p, g, m, v, **kw),
                    fa.adamw_update_plain(p, g, m, v, **kw)):
        assert _ulp_distance(a, b) <= 1


SMALL_N = (1, 3, 4, 5, 7, 8, 15, 16, 17, 31, 33)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8_e4m3"])
def test_hop_encode_every_path_on_card(cuda, name):
    """K2 bit for bit on views 0, 4, 8 and 12 bytes into a 1 Mi buffer
    and at small n; ``scalar_launches`` rises once for each view off a
    16-byte boundary and for nothing else."""
    buf = _normal(1 << 20, 11, outlier=True).to(cuda)
    cases = [(buf[off:], off != 0) for off in range(4)]
    cases += [(_normal(n, n, outlier=n > 2).to(cuda), False)
              for n in SMALL_N]
    for x, scalar in cases:
        before = fh.hop_encode.scalar_launches
        p, s = fh.hop_encode(name, x)
        assert fh.hop_encode.scalar_launches == before + scalar
        pp, sp = fh.encode_plain(name, x)
        assert _same_bits(p, pp), (name, x.numel())
        assert (s is None and sp is None) or torch.equal(s, sp)


def test_bf16_encode_special_values_on_card(cuda):
    """+-inf, -0, overflow to inf, subnormals and ties bit for bit with
    the card's cast on the vector path and the scalar loop; a NaN of
    either sign becomes 0x7fc0."""
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([nan, -nan, inf, -inf, -0.0, 0.0, 3.4e38, -3.4e38,
                      1e-40, -1e-40, 1.00390625, 1.01171875, -2.5],
                     device=cuda).repeat(3)
    for view in (x, x[1:]):
        p, _ = fh.hop_encode("bf16", view)
        bits = p.view(torch.int16)
        isnan = torch.isnan(view)
        assert bool((bits[isnan] == 0x7fc0).all())
        assert torch.equal(bits[~isnan],
                           view.to(torch.bfloat16).view(torch.int16)[~isnan])


def _adam_quartet(n, seed, cuda):
    return [(_normal(n, seed) * 0.05).to(cuda),
            (_normal(n, seed + 1) * 1e-3).to(cuda),
            (_normal(n, seed + 2) * 1e-4).to(cuda),
            (_normal(n, seed + 3) ** 2 * 1e-6).to(cuda)]


def _check_adamw(p, g, m, v, *, scalar, inplace=False):
    kw = dict(lr=1e-3, count=2)
    want = fa.adamw_update_plain(p, g, m, v, **kw)
    before = fa.adamw_update.scalar_launches
    got = fa.adamw_update(p, g, m, v, inplace=inplace, **kw)
    assert fa.adamw_update.scalar_launches == before + scalar
    for a, b in zip(got, want):
        assert _ulp_distance(a, b) <= 1


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_every_path_on_card(cuda, inplace):
    """K5 within 1 ulp on views 4, 8 and 12 bytes into 1 Mi buffers (the
    scalar loop) and at small n (vectors and the tail), out of place and
    in place; ``scalar_launches`` rises for the views only."""
    for off in (1, 2, 3):
        _check_adamw(*(t[off:] for t in _adam_quartet(1 << 20, off, cuda)),
                     scalar=True, inplace=inplace)
    for n in SMALL_N:
        _check_adamw(*_adam_quartet(n, n, cuda), scalar=False,
                     inplace=inplace)


def test_adamw_in_place_with_misaligned_g_on_card(cuda):
    """The optimizer's in-place call with ``g`` a view off a 16-byte
    boundary takes the scalar loop and stays within 1 ulp."""
    n = 4099
    p, _, m, v = _adam_quartet(n, 20, cuda)
    gbuf = (_normal(n + 3, 21) * 1e-3).to(cuda)
    for off in (1, 2, 3):
        _check_adamw(p, gbuf[off:off + n], m, v, scalar=True, inplace=True)
    _check_adamw(p, gbuf[:n], m, v, scalar=False, inplace=True)


def test_wrappers_count_only_kernel_launches(cuda):
    x = _normal(4096, 7).to(cuda)
    before = (fh.hop_absmax.launches, fh.hop_encode.launches,
              fh.hop_decode_add.launches)
    fh.encode_plain("int8", x)                  # plain: no launch
    p, s = fh.hop_encode("int8", x)             # K1 + K2
    fh.hop_decode_add("int8", p, s)             # K3
    after = (fh.hop_absmax.launches, fh.hop_encode.launches,
             fh.hop_decode_add.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("k,n", [(4, 1 << 16), (5, 4999), (16, 2048 + 37)])
def test_fused_reduce_kernel_matches_plain_on_card(cuda, k, n, dtype,
                                                   out_dtype):
    """K4 bit for bit: both add rows 0..k-1 in order in f32 and round
    once to the output type (vector path where n allows, else scalar)."""
    x = _normal(k * n, k + n, outlier=True).reshape(k, n).to(cuda, dtype)
    before = fused_reduce.launches
    got = fused_reduce(x, out_dtype=out_dtype)
    assert fused_reduce.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (n,)
    assert torch.equal(got, fused_reduce_plain(x, out_dtype))


def test_fused_reduce_kernel_exactness_pins_on_card(cuda):
    """The bf16 [1024, 1, ..., 1] column sums to exactly 1279 (a running
    bf16 sum stays at 1024); integer-valued rows at ragged n equal the
    float64 sum."""
    for n in (192, 4099):
        x = torch.cat([torch.full((1, n), 1024.0, dtype=torch.bfloat16),
                       torch.ones((255, n), dtype=torch.bfloat16)]).to(cuda)
        assert bool((fused_reduce(x, out_dtype=torch.float32) == 1279.0)
                    .all())
    for n in (2048 + 37, 3 * 2048 - 1):
        x = torch.arange(7 * n, dtype=torch.float64).reshape(7, n) % 513.0
        got = fused_reduce(x.to(cuda, torch.float32))
        assert torch.equal(got.cpu().double(), x.sum(0))


def _bf16_ulp_distance(a, b) -> int:
    def ordered(t):
        i = t.detach().cpu().contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _check_rmsnorm(cuda, rows, d, dtype):
    x = _normal(rows * d, 8).reshape(rows, d).to(cuda, dtype)
    s = (_normal(d, 9) * 0.1).to(cuda)
    before = frn.fused_rmsnorm.launches
    y, rstd = frn.fused_rmsnorm(x, s)
    assert frn.fused_rmsnorm.launches == before + 1
    yp, rp = frn.rmsnorm_plain(x, s)
    torch.testing.assert_close(rstd, rp, rtol=1e-5, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=0)
    else:
        assert _bf16_ulp_distance(y, yp) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [37, 4096])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, dtype):
    """K6: f32 within rtol 1e-5, bf16 within one bf16 ulp."""
    _check_rmsnorm(cuda, rows, 960, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [37, 4096])
def test_rmsnorm_kernel_at_gemma_width_on_card(cuda, rows, dtype):
    """K6 at gemma-7b's d_model, 3072, to the same bounds."""
    _check_rmsnorm(cuda, rows, 3072, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [37, 8192])
@pytest.mark.parametrize("d", [1024, 2048, 4096])
def test_rmsnorm_kernel_at_recurrent_widths_on_card(cuda, d, rows, dtype):
    """K6 at xlstm-350m's d_model (1024), zamba2-1.2b's (2048) and its
    shared block's norm over concat(hidden, embedding) (4096), at a
    ragged row count and at a served prompt's 2 x 4096 rows, to the same
    bounds."""
    _check_rmsnorm(cuda, rows, d, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("d,offset", [
    (960, 0), (2048, 0), (3072, 0), (4096, 0), (1000, 0), (1001, 0),
    (7, 0), (960, 1), (3072, 1)])
def test_rmsnorm_kernel_every_path_on_card(cuda, d, offset, rows, dtype):
    """K6 at every d_model of the registered configs (960, 2048, 3072,
    4096: one warp a row up to 1024 values, a block a row above), at
    widths that leave a lane's last vector partial (1000) or are no
    multiple of the vector width (1001, 7), and on a view one element into
    its storage: f32 within rtol 1e-5, bf16 within one bf16 ulp.
    ``scalar_launches`` rises exactly for the widths and views that the
    16-byte vectors cannot take."""
    n = rows * d
    flat = _normal(n + offset, d + rows).to(cuda, dtype)
    x = flat[offset:].view(rows, d)
    s = (_normal(d, 9) * 0.1).to(cuda)
    width = 16 // x.element_size()
    scalar = offset != 0 or d % width != 0
    before = (frn.fused_rmsnorm.launches, frn.fused_rmsnorm.scalar_launches)
    y, rstd = frn.fused_rmsnorm(x, s)
    assert (frn.fused_rmsnorm.launches, frn.fused_rmsnorm.scalar_launches
            ) == (before[0] + 1, before[1] + scalar)
    yp, rp = frn.rmsnorm_plain(x, s)
    torch.testing.assert_close(rstd, rp, rtol=1e-5, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=0)
    else:
        assert _bf16_ulp_distance(y, yp) <= 1


def _attn_inputs(shape, dtype, cuda, seed):
    return [_normal(int(np.prod(shape)), seed + i).reshape(shape)
            .to(cuda, dtype) for i in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,dh,causal,window", [
    (256, 64, True, 0), (300, 64, True, 100), (300, 64, False, 0),
    (130, 16, True, 0), (100, 128, False, 0), (256, 32, True, 0),
    (257, 32, True, 50), (190, 32, False, 0), (77, 16, False, 0),
    (333, 128, True, 0), (256, 256, True, 0), (333, 256, True, 100),
    (333, 256, False, 0), (77, 256, True, 0), (64, 256, True, 0),
    (4096, 256, True, 1024), (513, 256, False, 0), (333, 96, True, 0),
    (300, 96, True, 100), (257, 96, False, 0), (4096, 96, True, 0)])
def test_flash_kernels_match_plain_on_card(cuda, s, dh, causal, window,
                                           dtype):
    """K7 (out, lse) and K8 (dq, dk, dv) against the chunked plain
    versions: f32 forward atol 2e-5 / rtol 1e-4, backward 2e-3; bf16
    3e-2 (the kernel forms its scores in f32, the plain version in bf16,
    as the reference's two routes do).  Every head width runs at a
    ragged S, so bf16 covers each TMA swizzle (32-, 64-, 128-byte rows,
    three 64-byte boxes at dh 96, two or four 128-byte boxes at dh 128
    and 256) and the zero fill
    past S; at dh 256 the backward's own kernels at one tile (S = 64), a
    long window, ragged S and non-causal."""
    q, k, v, do = _attn_inputs((2, s, 3, dh), dtype, cuda, seed=s + dh)
    kw = dict(causal=causal, window=window, chunk=64)
    fwd = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    bwd = dict(atol=2e-3, rtol=2e-3) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    n7, n8 = fla.flash_attention_fwd.launches, fla.flash_attention_bwd.launches
    out, lse = fla.flash_attention_fwd(q, k, v, **kw)
    grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert (fla.flash_attention_fwd.launches, fla.flash_attention_bwd.launches
            ) == (n7 + 1, n8 + 1)
    torch.cuda.synchronize()
    pout, plse = fla.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), pout.float(), **fwd)
    torch.testing.assert_close(lse, plse, **fwd)
    pgrads = fla.flash_bwd_plain(q, k, v, pout, plse, do, **kw)
    for g, p, name in zip(grads, pgrads, ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), p.float(), msg=name, **bwd)


@pytest.mark.parametrize("s,dh,causal,window", [
    (4096, 64, True, 0), (300, 64, True, 100), (257, 32, False, 0),
    (130, 16, True, 0), (333, 128, True, 0), (4096, 256, True, 0),
    (333, 256, True, 100), (64, 256, True, 0), (4096, 256, True, 1024),
    (513, 256, False, 0), (4096, 96, True, 0), (300, 96, True, 100),
    (257, 96, False, 0), (77, 256, False, 0)])
def test_bf16_flash_kernels_are_deterministic_on_card(cuda, s, dh, causal,
                                                      window):
    """Two bf16 calls of K7 and of K8 give the same bits: every output
    tile has one owner and there are no atomics."""
    b, h = ((1, {64: 15, 96: 32}.get(dh, 16)) if s == 4096 else (2, 3))
    q, k, v, do = _attn_inputs((b, s, h, dh), torch.bfloat16, cuda,
                               seed=s + dh)
    kw = dict(causal=causal, window=window)
    out, lse = fla.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = fla.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    grads2 = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dh", [64, 96, 256])
def test_flash_bwd_passes_apart_match_the_whole_call_on_card(cuda, dh):
    """The delta kernel, the dq pass alone and the dk/dv pass alone (how
    chip_smoke times them) write the same bits as the whole backward, and
    count no launch."""
    q, k, v, do = _attn_inputs((2, 333, 3, dh), torch.bfloat16, cuda,
                               seed=dh)
    out, lse = fla.flash_attention_fwd(q, k, v)
    whole = fla.flash_attention_bwd(q, k, v, out, lse, do)
    delta = fla._delta_launch(out, do)
    n8 = fla.flash_attention_bwd.launches
    dq, _, _ = fla._bwd_launch(q, k, v, do, lse, delta, True, 0, passes=1)
    _, dk, dv = fla._bwd_launch(q, k, v, do, lse, delta, True, 0, passes=2)
    assert fla.flash_attention_bwd.launches == n8
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [333, 4096])
@pytest.mark.parametrize("dh", fla.HEAD_DIMS)
def test_delta_kernel_matches_plain_on_card(cuda, dh, s, dtype):
    """K8's rowsum(dO∘O) kernel against ``_delta`` per row within
    dh·2⁻²⁴·Σ|dO∘O| (both sum in f32, in different orders), and two
    calls give the same bits; at S 333 also through element loads (f32
    views off a 16-byte boundary)."""
    shape = (2, s, 3, dh)
    out, do = _attn_inputs(shape, dtype, cuda, seed=s + dh)[:2]
    pairs = [(out, do)]
    if dtype == torch.float32 and s == 333:
        n = int(np.prod(shape))
        flat = _normal(2 * n + 2, seed=dh).to(cuda)
        pairs.append((flat[1:n + 1].view(shape), flat[n + 2:].view(shape)))
        assert pairs[-1][0].data_ptr() % 16
    for o, g in pairs:
        got = fla._delta_launch(o, g)
        assert torch.equal(got, fla._delta_launch(o, g))
        assert ((got - fla._delta(o, g)).abs()
                <= fla.delta_tolerance(o, g)).all()


@pytest.mark.parametrize("sq,sk,off,dh", [(2048, 4096, 2048, 96),
                                          (2048, 4096, 2048, 256),
                                          (300, 513, 100, 96)])
def test_bf16_flash_kernels_with_a_query_offset_are_deterministic_on_card(
        cuda, sq, sk, off, dh):
    """Two bf16 calls of K7 and K8's offset build give the same bits."""
    q, _, _, do = _attn_inputs((1, sq, 8, dh), torch.bfloat16, cuda, seed=sq)
    _, k, v, _ = _attn_inputs((1, sk, 8, dh), torch.bfloat16, cuda, seed=sk)
    kw = dict(q_offset=off)
    out, lse = fla.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = fla.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    grads2 = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, g2)


def test_bf16_flash_kernels_refuse_unaligned_views_on_card(cuda):
    """TMA needs 16-byte aligned bases: a view two bytes into its storage
    raises instead of launching."""
    shape = (1, 128, 2, 64)
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    bad = flat[1:n + 1].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    n7, n8 = fla.flash_attention_fwd.launches, fla.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fla.flash_attention_fwd(bad, good, good)
    out, lse = fla.flash_attention_fwd(good, good, good)
    with pytest.raises(ValueError, match="16-byte"):
        fla.flash_attention_bwd(good, good, good, out, lse, bad)
    assert (fla.flash_attention_fwd.launches,
            fla.flash_attention_bwd.launches) == (n7 + 1, n8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,off,dh,causal,window", [
    (150, 300, 150, 64, True, 0), (100, 333, 233, 256, True, 100),
    (130, 257, 127, 96, True, 0), (64, 200, 0, 32, False, 0),
    (200, 200, 48, 16, True, 50), (77, 333, 90, 128, True, 0),
    (2048, 4096, 2048, 96, True, 0), (2048, 4096, 2048, 256, True, 0),
    (300, 513, 100, 96, False, 0), (333, 400, 67, 256, True, 100)])
def test_flash_kernels_with_a_query_offset_match_plain_on_card(
        cuda, dtype, sq, sk, off, dh, causal, window):
    """K7/K8's offset build (queries at positions ``off ..`` against keys
    0 .. sk-1, ragged on both sides, a window reaching past the first
    keys) against the plain versions, at the square tests' tolerances,
    and counted in ``offset_launches``."""
    q, _, _, do = _attn_inputs((2, sq, 3, dh), dtype, cuda, seed=sq + dh)
    _, k, v, _ = _attn_inputs((2, sk, 3, dh), dtype, cuda, seed=sk + off)
    kw = dict(causal=causal, window=window, chunk=64, q_offset=off)
    fwd = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    bwd = dict(atol=2e-3, rtol=2e-3) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    n7 = fla.flash_attention_fwd.offset_launches
    n8 = fla.flash_attention_bwd.offset_launches
    out, lse = fla.flash_attention_fwd(q, k, v, **kw)
    grads = fla.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert (fla.flash_attention_fwd.offset_launches,
            fla.flash_attention_bwd.offset_launches) == (n7 + 1, n8 + 1)
    torch.cuda.synchronize()
    pout, plse = fla.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), pout.float(), **fwd)
    torch.testing.assert_close(lse, plse, **fwd)
    pgrads = fla.flash_bwd_plain(q, k, v, pout, plse, do, **kw)
    for g, p, name in zip(grads, pgrads, ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), p.float(), msg=name, **bwd)


# ---------------------------------------------------------------------------
# The cuda_ipc channel's waits on the card (csrc/mailbox.cu): 2 ranks
# spawned once for the channel's tests (~20 s: the spawn, then one test
# wait of IPC_TIMEOUT_S for the peer that never posts), and 2 more for
# serving's (~40 s: the reduced smollm-360m served on a model axis of 2,
# then one test wait).
# ---------------------------------------------------------------------------

IPC_SLOT = 1 << 16
IPC_TIMEOUT_S = 5.0
IPC_HOPS = 7                   # back to back, more than SLOTS


def _raised(fn) -> str | None:
    try:
        fn()
    except (RuntimeError, TimeoutError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _ipc_hops(x, group, ring):
    """A round trip (there and back), then IPC_HOPS hops of mixed sizes
    back to back, as numpy."""
    from repro_torch.core import dist
    there = dist.ppermute(x, group, ring)
    back = dist.ppermute(there, group, ring)
    hops = [dist.ppermute(x[:1 + (977 * i) % x.numel()] + i, group, ring)
            for i in range(IPC_HOPS)]
    return [t.cpu().numpy() for t in (there, back, *hops)]


def _ipc_rank(rank, world):
    import time

    import torch.distributed as tdist
    from repro_torch.core import dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    x = torch.randn(3000, generator=torch.Generator(device=dev)
                    .manual_seed(rank), device=dev)
    ring = [(0, 1), (1, 0)]
    out = {"gloo": _ipc_hops(x, dist.Group(transport="gloo"), ring)}
    timeout, dist.MAILBOX_TIMEOUT_S = dist.MAILBOX_TIMEOUT_S, IPC_TIMEOUT_S
    try:
        ch = dist.IpcChannel(dist.Group(), IPC_SLOT, dev)
    finally:
        dist.MAILBOX_TIMEOUT_S = timeout
    with ch:
        out["ipc"] = _ipc_hops(x, ch.group, ring)
        ch.sync()
        out["waits"] = ch.waits
        # Rank 1 never posts until rank 0's sync has timed out; then it
        # posts what it owes, and rank 0's stream runs on.
        tdist.barrier()
        if rank == 0:
            ch.take(1, [x[:3]], dist._clone_all)
            t0 = time.monotonic()
            out["late"] = _raised(ch.sync)
            out["late_s"] = time.monotonic() - t0
        tdist.barrier()
        if rank == 1:
            ch.post(0, [x[:3]])
        out["recovered"] = _raised(ch.sync)
        # A payload of 8 bytes where rank 0 expects 12.
        tdist.barrier()
        if rank == 1:
            ch.post(0, [x[:2]])
        else:
            ch.take(1, [x[:3]], dist._clone_all)
            out["wrong"] = _raised(ch.sync)
        out["name"] = ch.name
    return out


def _ipc_serve(rank, world):
    """The serving path's channels (the model axis's gather boundary,
    ``serve/step.py``): the reduced smollm-360m served on a model axis of
    2, then served again on rank 0 alone, its peer staying out until rank
    0's readback of the first token has timed out; then the peer runs
    the prefill it owes and rank 0's channels sync."""
    import time

    import torch.distributed as tdist
    from repro_torch.core import dist
    from repro_torch.launch import serve
    torch.cuda.set_device(0)
    args = serve.parser().parse_args(
        ["--arch", "smollm-360m", "--mesh", "1x2", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "4", "--device", "cuda"])
    engine, batch = serve.build_engine(args)
    # The first generation opens the channels (and builds the kernels it
    # launches, on each rank in its own time, so at the default timeout).
    out = {"served": engine.generate(batch)}
    for ch in dist._open_channels:
        ch.timeout_s = IPC_TIMEOUT_S
    tdist.barrier()
    if rank == 0:
        t0 = time.monotonic()
        out["serve_late"] = _raised(lambda: engine.generate(batch))
        out["serve_late_s"] = time.monotonic() - t0
    tdist.barrier()
    if rank == 1:
        engine._prefill(engine.params, batch)
    out["serve_recovered"] = _raised(dist.sync_channels)
    return out


@pytest.fixture(scope="module")
def ipc_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import tempfile
    from repro_torch.core import dist
    with tempfile.TemporaryDirectory() as rdv:
        return dist.run_ranks(_ipc_rank, 2, backend="cuda_ipc",
                              rendezvous_dir=rdv, timeout_s=300)


def test_device_waited_hops_match_gloo_on_card(ipc_ranks):
    """A round trip and more than SLOTS hops back to back through the
    waits on the card, bit for bit the gloo transport's; every hop
    enqueued its waits."""
    for r in ipc_ranks:
        assert len(r["ipc"]) == len(r["gloo"]) == 2 + IPC_HOPS
        for got, want in zip(r["ipc"], r["gloo"]):
            assert got.dtype == want.dtype and np.array_equal(
                got.view(np.uint8), want.view(np.uint8))
        # a notify per hop, and a slot wait from the third post on
        assert r["waits"] == 2 * (2 + IPC_HOPS) - 2


def test_a_peer_that_never_posts_times_out_naming_it_on_card(ipc_ranks):
    r = ipc_ranks[0]
    assert r["late"] is not None and r["late"].startswith("TimeoutError")
    assert "no notify from rank 1 (global rank 1)" in r["late"], r["late"]
    assert r["name"] in r["late"] and "expected seq 9" in r["late"]
    assert IPC_TIMEOUT_S <= r["late_s"] < IPC_TIMEOUT_S + 30
    assert r["recovered"] is None and ipc_ranks[1]["recovered"] is None


def test_a_wrong_byte_count_raises_on_card(ipc_ranks):
    msg = ipc_ranks[0]["wrong"]
    assert msg is not None and msg.startswith("RuntimeError"), msg
    assert "rank 1 sent the notify [10, 0, 8]" in msg, msg
    assert "expected (seq, slot, bytes) [10, 0, 12]" in msg, msg


@pytest.fixture(scope="module")
def serve_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import tempfile
    from repro_torch.core import dist
    with tempfile.TemporaryDirectory() as rdv:
        return dist.run_ranks(_ipc_serve, 2, backend="cuda_ipc",
                              rendezvous_dir=rdv, timeout_s=300)


def test_a_serving_peer_that_never_posts_times_out_naming_it_on_card(
        serve_ranks):
    """Serving's channels have no executor that syncs them: the engine's
    readback of a token syncs them first, so a peer that never posts
    ends in the channel's ``TimeoutError``, not a hang in the device
    sync."""
    assert np.array_equal(serve_ranks[0]["served"],
                          serve_ranks[1]["served"])
    r = serve_ranks[0]
    assert r["serve_late"] is not None, "the second generation returned"
    assert r["serve_late"].startswith("TimeoutError: cuda_ipc channel ")
    assert "no notify from rank 1 (global rank 1)" in r["serve_late"]
    assert "expected seq " in r["serve_late"]
    assert IPC_TIMEOUT_S <= r["serve_late_s"] < IPC_TIMEOUT_S + 30
    assert r["serve_recovered"] is None
    assert serve_ranks[1]["serve_recovered"] is None
