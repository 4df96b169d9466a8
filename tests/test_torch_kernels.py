"""The port's kernels K1/K2/K3 (fused hop), K4 (fused reduce) and K5
(AdamW) against the JAX reference, on the CPU.

On the CPU each wrapper runs its plain torch version (the kernel's
arithmetic, under the flush-to-zero guard), so these tests hold that
arithmetic to the reference's: ``repro.core.codec.encode/decode`` and
``repro.kernels.fused_hop`` (direct lowering and, on a small case, the
Pallas interpreter) bit for bit on payload and scale, across the normal,
zero, subnormal and outlier regimes of tests/test_codec_properties.py;
K4 bit for bit with ``repro.kernels.ref.fused_reduce_ref`` and the
Pallas kernel in interpret mode for k <= 16 (XLA adds the rows in order
there too); K5 to 1 ulp of ``repro.kernels.ref.adamw_update_ref`` and to
rtol 1e-6 of ``repro.optim.adamw`` (which squares ``g`` before scaling
it).  The
kernels themselves are held to the plain versions on the card by
tests/test_torch_kernels_on_card.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import codec as jcodec
from repro.kernels import fused_hop as jfh
from repro.kernels import ref as jref
from repro.kernels.fused_reduce import fused_reduce as pallas_reduce
from repro.optim import optimizers as joptim

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core import codec as tcodec
from repro_torch.kernels import backend
from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels import fused_hop as fh
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_reduce import fused_reduce, fused_reduce_plain

CODED = ("bf16", "int8", "fp8_e4m3")
REGIMES = ("normal", "zero", "subnormal", "outlier", "subnormal_absmax")


def _buffer(n, regime, seed):
    rng = np.random.default_rng(seed)
    if regime == "zero":
        return np.zeros(n, np.float32)
    if regime == "subnormal":
        return (rng.standard_normal(n) * 1e-38).astype(np.float32)
    if regime == "subnormal_absmax":
        return (np.sign(rng.standard_normal(n)) * 4.4e-39).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    if regime == "outlier":
        x[rng.integers(0, n)] = 1e4
    return x


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(_bits(a), _bits(b))


def _t(x):
    return tensor_to_numpy(x) if x is not None else None


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("name", CODED)
def test_encode_matches_reference_codec(name, regime):
    """K2's plain version == codec.encode and fused_hop.hop_encode."""
    x = _buffer(1537, regime, seed=len(regime) * 7 + len(name))
    tp, ts = fh.hop_encode(name, torch.from_numpy(x))
    jp, js = jcodec.encode(name, jnp.asarray(x))
    fp, fs = jfh.hop_encode(name, jnp.asarray(x))
    assert _same_bits(_t(tp), jp), f"{name}/{regime}: payload != codec"
    assert _same_bits(_t(tp), fp), f"{name}/{regime}: payload != fused_hop"
    if js is None:
        assert ts is None
    else:
        assert _same_bits(_t(ts), js) and _same_bits(_t(ts), fs), \
            f"{name}/{regime}: scale {float(ts)} != {float(js)}"


@pytest.mark.parametrize("regime", REGIMES)
def test_absmax_matches_reference(regime):
    x = _buffer(3001, regime, seed=11)
    got = fh.hop_absmax(torch.from_numpy(x))
    want = jfh.hop_absmax(jnp.asarray(x))
    assert _same_bits(_t(got), want), f"{regime}: {float(got)} != {want}"


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("name,with_add",
                         [(c, a) for c in CODED for a in (True, False)]
                         + [("none", True)])   # none without add: identity
def test_decode_add_matches_reference(name, regime, with_add):
    """K3's plain version == fused_hop.hop_decode_add (and, without the
    add, codec.decode) on the reference's own payloads."""
    x = _buffer(1024, regime, seed=5)
    add = _buffer(1024, "normal" if regime == "zero" else regime, seed=6) \
        if with_add else None
    jp, js = jcodec.encode(name, jnp.asarray(x))
    want = jfh.hop_decode_add(name, jp, js,
                              None if add is None else jnp.asarray(add))
    tp = torch.from_numpy(np.asarray(jp).view(np.uint8).copy()).view(
        {"bf16": torch.bfloat16, "int8": torch.int8,
         "fp8_e4m3": torch.float8_e4m3fn, "none": torch.float32}[name]) \
        if name != "int8" else torch.from_numpy(np.asarray(jp).copy())
    ts = None if js is None else torch.tensor(float(js), dtype=torch.float32)
    got = fh.hop_decode_add(name, tp, ts,
                            None if add is None else torch.from_numpy(add))
    assert _same_bits(_t(got), want), f"{name}/{regime}/add={with_add}"
    if add is None:
        assert _same_bits(_t(tcodec.decode(name, tp, ts)),
                          jcodec.decode(name, jp, js))


@pytest.mark.parametrize("name", CODED)
def test_small_case_matches_pallas_interpreter(name):
    """The Pallas kernels run through the interpreter on a small ragged
    buffer: encode is bit-exact; decode+add within one rounding of the
    accumulate (the interpreter may contract it into an FMA — the bound
    tests/test_fused_hop.py states)."""
    x = _buffer(300, "outlier", seed=3)
    add = _buffer(300, "normal", seed=4)
    jp, js = jfh.hop_encode(name, jnp.asarray(x), interpret=True)
    tp, ts = fh.hop_encode(name, torch.from_numpy(x))
    assert _same_bits(_t(tp), jp)
    if js is not None:
        assert _same_bits(_t(ts), js)
    want = np.asarray(jfh.hop_decode_add(name, jp, js, jnp.asarray(add),
                                         interpret=True))
    got = _t(fh.hop_decode_add(name, tp, ts, torch.from_numpy(add)))
    bound = 2.0 ** -20 * float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= bound


def test_subnormal_absmax_flushes_like_the_reference():
    """F1 settled: a subnormal absmax (4.4e-39) reads as zero under
    flush-to-zero, so ``safe = 1`` and ``scale = 1/127`` — not the
    ``tiny`` clamp an unflushed host would take."""
    x = torch.full((64,), 4.4e-39, dtype=torch.float32)
    _, scale = fh.hop_encode("int8", x)
    assert float(scale) == float(np.float32(1.0) / np.float32(127.0))
    _, jscale = jcodec.encode("int8", jnp.asarray(x.numpy()))
    assert float(scale) == float(jscale)


def test_flush_denormal_guard_is_scoped():
    tiny = torch.tensor(1e-39, dtype=torch.float32)
    threads = torch.get_num_threads()
    assert float(tiny * 1.0) != 0.0
    with backend.flush_denormal():
        assert float(tiny * 1.0) == 0.0
        assert torch.get_num_threads() == 1
    assert float(tiny * 1.0) != 0.0
    assert torch.get_num_threads() == threads


def _ulp_distance(a, b) -> int:
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.max(np.abs(ordered(a) - ordered(b))))


def _adam_inputs(n, seed):
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal(n) * 0.05).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-4).astype(np.float32)
    v = (rng.standard_normal(n) ** 2 * 1e-6).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("count", [1, 2, 7])
def test_adamw_update_matches_ref_within_one_ulp(count):
    p, g, m, v = _adam_inputs(4099, seed=count)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              count=count)
    got = fa.adamw_update(*(torch.from_numpy(a) for a in (p, g, m, v)),
                          **kw)
    want = jref.adamw_update_ref(*(jnp.asarray(a) for a in (p, g, m, v)),
                                 **kw)
    for gt, wt in zip(got, want):
        assert _ulp_distance(_t(gt), wt) <= 1
    plain = tref.adamw_update_ref(*(torch.from_numpy(a)
                                    for a in (p, g, m, v)), **kw)
    for gt, pt in zip(got, plain):
        assert torch.equal(gt, pt)


def test_adamw_inplace_is_the_same_update():
    p, g, m, v = _adam_inputs(513, seed=9)
    kw = dict(lr=1e-3, count=1)
    out = fa.adamw_update(*(torch.from_numpy(a) for a in (p, g, m, v)),
                          **kw)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    res = fa.adamw_update(tp, torch.from_numpy(g), tm, tv, inplace=True,
                          **kw)
    assert res[0] is tp and res[1] is tm and res[2] is tv
    for a, b in zip(out, (tp, tm, tv)):
        assert torch.equal(a, b)


def test_port_adamw_matches_reference_optimizer():
    """The port's ``optim.adamw`` (K5 per leaf, in place) against the
    reference's jnp ``adamw`` for three steps: rtol 1e-6, because
    ``(1-b2)*g*g`` rounds differently from ``(1-b2)*square(g)``."""
    from repro_torch.optim import adamw as tadamw
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (33,), "d": (2, 3, 4)}}
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(33).astype(np.float32),
                    "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    jopt = joptim.adamw(1e-2)
    jparams = {"a": jnp.asarray(params["a"]),
               "b": {k: jnp.asarray(v) for k, v in params["b"].items()}}
    jstate = jopt.init(jparams)
    topt = tadamw(1e-2)
    tparams = {"a": torch.from_numpy(params["a"].copy()),
               "b": {k: torch.from_numpy(v.copy())
                     for k, v in params["b"].items()}}
    tstate = topt.init(tparams)
    for step in range(3):
        grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
                 "b": {k: rng.standard_normal(s).astype(np.float32)
                       for k, s in shapes["b"].items()}}
        jg = {"a": jnp.asarray(grads["a"]),
              "b": {k: jnp.asarray(v) for k, v in grads["b"].items()}}
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = {"a": jparams["a"] + upd["a"],
                   "b": {k: jparams["b"][k] + upd["b"][k]
                         for k in jparams["b"]}}
        tg = {"a": torch.from_numpy(grads["a"]),
              "b": {k: torch.from_numpy(v) for k, v in grads["b"].items()}}
        tstate = topt.update(tg, tstate, tparams)
    np.testing.assert_allclose(tparams["a"].numpy(), np.asarray(jparams["a"]),
                               rtol=1e-6, atol=1e-7)
    for k in shapes["b"]:
        np.testing.assert_allclose(tparams["b"][k].numpy(),
                                   np.asarray(jparams["b"][k]),
                                   rtol=1e-6, atol=1e-7)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor on neither the CPU nor CUDA raises."""
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError):
        fh.hop_absmax(x)
    with pytest.raises(ValueError):
        fh.hop_encode("int8", x)
    with pytest.raises(ValueError):
        fa.adamw_update(x, x, x, x, lr=1e-3)
    with pytest.raises(ValueError):
        fused_reduce(x.reshape(2, 8))


# ---------------------------------------------------------------------------
# K4: fused chunk reduction
# ---------------------------------------------------------------------------

def _stack(k, n, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((k, n)) \
        .astype(np.float32)
    return x if dtype == "float32" else x.astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [128, 2048, 4999])
@pytest.mark.parametrize("k", [2, 5, 16])
def test_fused_reduce_matches_reference_and_pallas_interpreter(k, n, dtype):
    """tests/test_kernels.py's grid, bit for bit, in the input's dtype
    and in f32 out; the port's own oracle (one ``torch.sum``) within
    the reference's tolerance there (1e-6 f32, 2e-2 bf16)."""
    x = _stack(k, n, dtype, k * n)
    got = fused_reduce(tensor_from_numpy(x))
    assert got.dtype == tensor_from_numpy(x).dtype and got.shape == (n,)
    assert _same_bits(_t(got), jref.fused_reduce_ref(jnp.asarray(x)))
    assert _same_bits(_t(got), pallas_reduce(jnp.asarray(x),
                                             interpret=True))
    got32 = fused_reduce(tensor_from_numpy(x), out_dtype=torch.float32)
    assert _same_bits(_t(got32), jref.fused_reduce_ref(
        jnp.asarray(x), out_dtype=jnp.float32))
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(
        _t(got).astype(np.float32),
        _t(tref.fused_reduce_ref(tensor_from_numpy(x))).astype(np.float32),
        rtol=tol, atol=tol)


def test_fused_reduce_f32_to_bf16_rounds_once():
    """f32 rows summed in f32, then one round-to-nearest-even to bf16:
    the reference's ``out_dtype`` cast."""
    x = _stack(5, 4999, "float32", 3)
    got = fused_reduce(tensor_from_numpy(x), out_dtype=torch.bfloat16)
    want = jref.fused_reduce_ref(jnp.asarray(x), out_dtype=jnp.bfloat16)
    assert _same_bits(_t(got), want)


def test_fused_reduce_bf16_provably_loses_bits_sequentially():
    """The bf16 [1024, 1, ..., 1] column: a running bf16 sum stays at
    1024 (its ulp there is 8), the f32 accumulator gives exactly 1279."""
    k, n = 256, 192
    x = torch.cat([torch.full((1, n), 1024.0, dtype=torch.bfloat16),
                   torch.ones((k - 1, n), dtype=torch.bfloat16)])
    seq = x[0]
    for i in range(1, k):
        seq = seq + x[i]
    assert bool((seq == 1024.0).all())
    got = fused_reduce(x, out_dtype=torch.float32)
    assert bool((got == 1024.0 + (k - 1)).all())


def test_fused_reduce_ragged_tail_exact():
    """Integer-valued rows at n past a multiple of any tile: exact, so
    bit for bit the float64 sum and the Pallas kernel's padded tiles."""
    k, block_n = 7, 2048
    for n in (block_n + 37, 3 * block_n - 1):
        x = (np.arange(k * n, dtype=np.float32).reshape(k, n) % 513.0)
        got = _t(fused_reduce(torch.from_numpy(x)))
        assert got.shape == (n,)
        assert (got.astype(np.float64) == x.astype(np.float64).sum(0)).all()
        assert _same_bits(got, pallas_reduce(jnp.asarray(x),
                                             block_n=block_n,
                                             interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_reduce_subnormals_flush_like_the_reference(dtype):
    """Subnormal addends and sums flush to zero under the guard, as
    XLA's do: a normal pair whose sum is subnormal gives zero."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 4096)) * 8e-39).astype(np.float32)
    x[0, ::3], x[1, ::3] = 1.5e-38, -1.4e-38
    x = x if dtype == "float32" else x.astype(jnp.bfloat16)
    got = fused_reduce(tensor_from_numpy(x), out_dtype=torch.float32)
    want = jref.fused_reduce_ref(jnp.asarray(x), out_dtype=jnp.float32)
    assert _same_bits(_t(got), want)
    assert float(got[0]) == 0.0


def test_fused_reduce_plain_copies_a_single_row():
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)
    out = fused_reduce_plain(x)
    out += 1.0
    assert torch.equal(x, torch.arange(6, dtype=torch.float32).reshape(1, 6))


# ---------------------------------------------------------------------------
# K6: fused RMSNorm
# ---------------------------------------------------------------------------

RMS_SHAPES = [(8, 128), (3, 37, 128), (500, 256), (37, 960)]


def _bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _rms_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return x, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_matches_reference_and_pallas_interpreter(shape, dtype):
    """K6's plain version against ``repro.models.common.rmsnorm`` and the
    Pallas ``fused_rmsnorm`` in interpret mode: f32 within rtol 1e-5
    (the row sums run in other orders), bf16 within one bf16 ulp."""
    from repro.kernels.fused_rmsnorm import fused_rmsnorm as jfused
    from repro.models.common import rmsnorm as jrmsnorm
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.kernels import fused_rmsnorm as frn
    x, s = _rms_inputs(shape, seed=shape[-1] + len(shape))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    wants = [jrmsnorm(jx, jnp.asarray(s)),
             jfused(jx, jnp.asarray(s), block_rows=64, interpret=True)]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, rstd = frn.fused_rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and rstd.shape == shape[:-1]
    assert frn.fused_rmsnorm.launches == 0      # the CPU runs no kernel
    for want in wants:
        want_t = tensor_from_numpy(np.asarray(want))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=0)
        else:
            assert _bf16_ulp_distance(got, want_t) <= 1
    np.testing.assert_array_equal(
        tref.rmsnorm_ref(tx, torch.from_numpy(s)).float().numpy(),
        got.float().numpy())


@pytest.mark.parametrize("shape", [(3, 37, 128), (37, 960)])
def test_rmsnorm_grad_matches_jax_grad(shape):
    """``RMSNormFn``'s closed-form backward against ``jax.grad`` of the
    reference's rmsnorm, in f32, for both ``x`` and ``scale``: rtol 1e-5,
    plus an absolute slack of 2⁻²⁰·max|grad| where ``g·w − x̂·mean(·)``
    cancels (the two sides round that difference at different steps)."""
    import jax
    from repro.models.common import rmsnorm as jrmsnorm
    from repro_torch.kernels.fused_rmsnorm import RMSNormFn
    x, s = _rms_inputs(shape, seed=3)
    gy = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jdx, jds = jax.grad(lambda a, b: (jrmsnorm(a, b) * jnp.asarray(gy)).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    RMSNormFn.apply(tx, ts, 1e-6).backward(torch.from_numpy(gy))
    for got, want in ((tx.grad, jdx), (ts.grad, jds)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2.0 ** -20 * np.abs(want).max())


def test_rmsnorm_wrapper_refuses_other_devices():
    """Mixed devices are refused.  Meta tensors alone take the plain
    version, launching nothing: the dry run counts its arithmetic
    (``launch/roofline.py``)."""
    from repro_torch.kernels import fused_rmsnorm as frn
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        frn.fused_rmsnorm(torch.zeros(4, 16), torch.empty(16, device="meta"))
    with pytest.raises(ValueError):
        frn.fused_rmsnorm(x, torch.zeros(16))
    before = frn.fused_rmsnorm.launches
    y, rstd = frn.fused_rmsnorm(x, torch.empty(16, device="meta"))
    assert (y.device.type, tuple(y.shape), tuple(rstd.shape)) == \
        ("meta", (4, 16), (4,))
    assert frn.fused_rmsnorm.launches == before
