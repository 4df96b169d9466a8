"""The port's flash attention (K7/K8's plain versions, ``FlashAttnFn``,
``sdpa_chunked``) against the JAX reference, on the CPU.

On the CPU ``FlashAttnFn`` runs the chunked plain versions, torch
transcriptions of the reference's ``_flash_fwd_impl``/``_flash_bwd``.
They are held, on the same numpy inputs, to:

* ``repro.models.attention.sdpa_chunked`` (forward and ``jax.vjp``) at
  (1, 128, 4 query / 2 kv heads, 16), chunk 16: causal, window 100 and
  non-causal (the reference reaches it with every query position past
  the last key), at S = 128 and a ragged S = 100 that forces padding.
  The kv gradients come back summed over each group of repeated heads;
* the Pallas ``flash_attention_fwd/bwd`` in interpret mode at
  (1, 128, 2, 64), at gemma-7b's head_dim, (1, 128, 2, 256), and at
  phi-3-vision's, (1, 128, 2, 96), both also held to ``sdpa_chunked``
  in all three modes;
* the naive oracle ``repro.kernels.ref.flash_attention_ref`` and its
  ``jax.grad``.

Tolerances are the reference's own (tests/test_kernels.py): f32 forward
atol 2e-5 / rtol 1e-4, backward 2e-3, bf16 3e-2.  The kernels are held
to these plain versions on the card by
tests/test_torch_kernels_on_card.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.configs import get_spec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

MODES = [(True, 0), (True, 100), (False, 0)]
FWD = dict(atol=2e-5, rtol=1e-4)
BWD = dict(atol=2e-3, rtol=2e-3)


def _qkvo(shape, kv_heads, seed):
    rng = np.random.default_rng(seed)
    b, s, h, dh = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, s, kv_heads, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv_heads, dh)).astype(np.float32)
    do = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, do


def _jax_positions(s, causal):
    k_pos = jnp.arange(s, dtype=jnp.int32)
    # Non-causal: every query sits past the last key (padded keys, at
    # 2**30, stay masked).
    q_pos = k_pos if causal else jnp.full((s,), s, jnp.int32)
    return q_pos, k_pos


def _port_sdpa(causal, window):
    """The port's ``sdpa_chunked``; non-causal (which the model never
    runs) as the same kv repeat in front of ``FlashAttnFn``."""
    if causal:
        return lambda q, k, v: tattn.sdpa_chunked(q, k, v, window, 16)

    def run(q, k, v):
        rep = q.shape[2] // k.shape[2]
        return fa.FlashAttnFn.apply(q, torch.repeat_interleave(k, rep, 2),
                                    torch.repeat_interleave(v, rep, 2),
                                    False, window, 16)
    return run


def _port_grads(fn, arrays, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check_sdpa_forward(shape, kv_heads, causal, window, seed):
    s = shape[1]
    q, k, v, _ = _qkvo(shape, kv_heads, seed=seed)
    q_pos, k_pos = _jax_positions(s, causal)
    want = jattn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos, k_pos, window, 16)
    with torch.no_grad():
        got = _port_sdpa(causal, window)(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _check_sdpa_vjp(shape, kv_heads, causal, window, seed):
    q, k, v, do = _qkvo(shape, kv_heads, seed=seed)
    q_pos, k_pos = _jax_positions(shape[1], causal)
    _, vjp = jax.vjp(lambda a, b, c: jattn.sdpa_chunked(
        a, b, c, q_pos, k_pos, window, 16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    _, got = _port_grads(_port_sdpa(causal, window), (q, k, v), do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name          # summed back to the kv heads
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **BWD)


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal,window", MODES)
def test_sdpa_chunked_forward_matches_reference(s, causal, window):
    _check_sdpa_forward((1, s, 4, 16), 2, causal, window, seed=s + window)


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal,window", MODES)
def test_sdpa_chunked_vjp_matches_reference(s, causal, window):
    _check_sdpa_vjp((1, s, 4, 16), 2, causal, window, seed=3 * s + window)


@pytest.mark.parametrize("causal,window", MODES)
def test_sdpa_chunked_at_head_dim_256_matches_reference(causal, window):
    """gemma-7b's head width, (1, 128, 2, 256): forward and ``jax.vjp``."""
    _check_sdpa_forward((1, 128, 2, 256), 2, causal, window,
                        seed=256 + window)
    _check_sdpa_vjp((1, 128, 2, 256), 2, causal, window, seed=512 + window)


@pytest.mark.parametrize("causal,window", MODES)
def test_sdpa_chunked_at_head_dim_96_matches_reference(causal, window):
    """phi-3-vision's head width at a ragged S, (1, 100, 2, 96): forward
    and ``jax.vjp``."""
    _check_sdpa_forward((1, 100, 2, 96), 2, causal, window, seed=96 + window)
    _check_sdpa_vjp((1, 100, 2, 96), 2, causal, window, seed=960 + window)


def _check_plain_vs_interpreter(shape, causal, window):
    """``shape`` against the Pallas kernels run by the interpreter: out
    and lse forward, then (dq, dk, dv) from each side's own out/lse."""
    q, k, v, do = _qkvo(shape, shape[2], seed=7)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jfa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                         window=window, interpret=True,
                                         return_lse=True)
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                     causal=causal, window=window,
                                     interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                      window=window, chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD)
    grads = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal,
                                   window=window, chunk=32)
    for g, w, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD)


@pytest.mark.parametrize("causal,window", MODES)
def test_plain_versions_match_pallas_interpreter(causal, window):
    """(1, 128, 2, 64) against the Pallas kernels (interpret mode)."""
    _check_plain_vs_interpreter((1, 128, 2, 64), causal, window)


@pytest.mark.parametrize("causal,window", MODES)
def test_plain_versions_match_pallas_interpreter_at_head_dim_256(causal,
                                                                 window):
    """(1, 128, 2, 256), gemma-7b's head width, against the Pallas
    kernels (interpret mode), which take any head_dim."""
    _check_plain_vs_interpreter((1, 128, 2, 256), causal, window)


@pytest.mark.parametrize("causal,window", MODES)
def test_plain_versions_match_pallas_interpreter_at_head_dim_96(causal,
                                                                window):
    """(1, 128, 2, 96), phi-3-vision's head width, against the Pallas
    kernels (interpret mode)."""
    _check_plain_vs_interpreter((1, 128, 2, 96), causal, window)


@pytest.mark.parametrize("causal,window", MODES)
def test_flash_fn_matches_naive_oracle_and_its_grad(causal, window):
    q, k, v, do = _qkvo((2, 96, 3, 32), 3, seed=11)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = jref.flash_attention_ref(*jargs, causal=causal, window=window)
    jgrads = jax.grad(lambda a, b, c: (jref.flash_attention_ref(
        a, b, c, causal=causal, window=window) * jnp.asarray(do)).sum(),
        argnums=(0, 1, 2))(*jargs)
    with torch.no_grad():
        oracle = tref.flash_attention_ref(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            window=window)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **FWD)
    out, grads = _port_grads(lambda a, b, c: fa.FlashAttnFn.apply(
        a, b, c, causal, window, 32), (q, k, v), do)
    np.testing.assert_allclose(out, np.asarray(want), **FWD)
    for g, w, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **BWD)


@pytest.mark.parametrize("chunk", [16, 48, 128])
def test_plain_result_does_not_depend_on_the_chunk(chunk):
    """The kernel tiles by 64 and the model's plain path by its
    ``attn_chunk``: the function is the same at any chunk."""
    q, k, v, do = _qkvo((1, 100, 2, 16), 2, seed=5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    base = fa.flash_attention_fwd(tq, tk, tv, window=30, chunk=64)
    out = fa.flash_attention_fwd(tq, tk, tv, window=30, chunk=chunk)
    for a, b in zip(out, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)
    g0 = fa.flash_attention_bwd(tq, tk, tv, *base, tdo, window=30, chunk=64)
    g1 = fa.flash_attention_bwd(tq, tk, tv, *base, tdo, window=30,
                                chunk=chunk)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BWD)


def test_bf16_forward_matches_reference():
    q, k, v, _ = _qkvo((1, 128, 4, 16), 2, seed=2)
    q_pos, k_pos = _jax_positions(128, True)
    want = jattn.sdpa_chunked(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), q_pos, k_pos, 0, 16)
    with torch.no_grad():
        got = tattn.sdpa_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                                   for a in (q, k, v)), 0, 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("s", [64, 128])
def test_sdpa_dispatch_matches_reference(s):
    """The reduced smollm-360m's ``sdpa``: plain attention up to
    ``attn_full_seq_max`` (64), the flash path above it."""
    jspec = dataclasses.replace(jget_spec("smollm-360m").reduced(),
                                dtype="float32")
    tspec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                                dtype="float32")
    q, k, v, _ = _qkvo((2, s, 4, 64), 2, seed=s)
    pos = np.arange(s, dtype=np.int32)
    want = jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos),
                      jnp.asarray(pos), jspec)
    with torch.no_grad():
        got = tattn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                         torch.from_numpy(pos), torch.from_numpy(pos), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_wrappers_refuse_other_devices():
    """Mixed devices are refused.  Meta tensors alone take the plain
    versions, launching nothing: the dry run counts their arithmetic
    (``launch/roofline.py``)."""
    x = torch.empty((1, 64, 2, 16), device="meta")
    c = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(c, x, x)
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(x, x, x, x, torch.zeros((1, 2, 64)), x)
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches)
    out, got_lse = fa.flash_attention_fwd(x, x, x)
    assert (out.device.type, tuple(out.shape), tuple(got_lse.shape)) == \
        ("meta", (1, 64, 2, 16), (1, 2, 64))
    grads = fa.flash_attention_bwd(x, x, x, x, lse, x)
    assert [tuple(g.shape) for g in grads] == [(1, 64, 2, 16)] * 3
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == launches


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernels' arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
TC_MODES = [(True, 0), (True, 40), (False, 0)]
BF16 = dict(atol=3e-2, rtol=3e-2)


def _visible(s, n, causal, window):
    """(n, n) mask of positions 0..n-1, keys and queries past S hidden."""
    qp = torch.arange(n)[:, None]
    kp = torch.arange(n)[None, :]
    m = (qp < s) & (kp < s)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= (qp - kp) < window
    return m


def _tc_emulate(q, k, v, do, causal, window, tile=64):
    """What K7/K8's bf16 kernels compute: bf16 operands with f32 sums,
    the softmax in base 2 over 64-key tiles with a running max, P rounded
    to bf16 before P·V and dS rounded to bf16 before dS·K and dSᵀ·Q.
    At head_dim 256 the backward's own kernels stage P and dS in shared
    memory between its two consumer warpgroups, rounded to bf16 at the
    same points (P and dS are elementwise, from the forward's lse), so
    this emulation holds there too; so it does for the forward at 256
    and the backward at 96, whose products span the whole head width
    (the same sums in the same order as three or four box-wide ones).
    Takes and returns (B, S, H, dh) bf16; lse (B, H, S) f32."""
    b, s, h, dh = q.shape
    n = -(-s // tile) * tile
    qf, kf, vf, dof = (fa._pad_seq(t, n).float().transpose(1, 2)
                       for t in (q, k, v, do))
    scale = fa._scale(dh)
    scale_log2 = float(np.float32(scale) * LOG2E)
    vis = _visible(s, n, causal, window)
    sc = torch.where(vis, (qf @ kf.transpose(-1, -2)) * scale_log2,
                     fa.NEG_INF)
    m = torch.full((b, h, n), fa.NEG_INF)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, dh))
    for j in range(0, n, tile):
        st = sc[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.bfloat16().float() @ vf[..., j:j + tile, :]
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).bfloat16()
    lse = m * float(LN2) + torch.log(l_safe)
    delta = (dof * out.float()).sum(-1)
    p = torch.where(vis, torch.exp2(sc - (lse * float(LOG2E))[..., None]),
                    0.0)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta[..., None])) * scale
    ds16, p16 = ds.bfloat16().float(), p.bfloat16().float()
    grads = (ds16 @ kf, ds16.transpose(-1, -2) @ qf,
             p16.transpose(-1, -2) @ dof)

    def back(t):
        return t.transpose(1, 2)[:, :s].bfloat16()
    return back(out), lse[..., :s], tuple(back(g) for g in grads)


def _bf16_inputs(shape, seed):
    q, k, v, do = _qkvo(shape, shape[2], seed)
    return [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=name,
                               **BF16)


@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 96, 3, 32),
                                   (1, 128, 2, 256), (1, 128, 2, 96)])
@pytest.mark.parametrize("causal,window", TC_MODES)
def test_tensor_core_rounding_matches_pallas_interpreter(shape, causal,
                                                         window):
    """The emulated bf16 kernel arithmetic against the reference's Pallas
    kernels (interpret mode, f32 inside, bf16 out) at 3e-2."""
    q, k, v, do = _bf16_inputs(shape, seed=shape[1] + window)
    out, lse, grads = _tc_emulate(q, k, v, do, causal, window)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))
    blk = dict(block_q=32, block_k=32) if shape[1] % 128 else {}
    jout, jlse = jfa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                         window=window, interpret=True,
                                         return_lse=True, **blk)
    _close(out, jout, "out")
    _close(lse, jlse, "lse")
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                     causal=causal, window=window,
                                     interpret=True, **blk)
    for g, w, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        _close(g, w, name)


@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 96, 3, 32),
                                   (1, 128, 2, 256), (1, 128, 2, 96)])
@pytest.mark.parametrize("causal,window", TC_MODES)
def test_tensor_core_rounding_matches_sdpa_chunked(shape, causal, window):
    """The emulated bf16 kernel arithmetic against the reference model's
    ``sdpa_chunked`` in bf16, forward and ``jax.vjp``, at 3e-2."""
    s = shape[1]
    q, k, v, do = _bf16_inputs(shape, seed=2 * s + window)
    out, _, grads = _tc_emulate(q, k, v, do, causal, window)
    q_pos, k_pos = _jax_positions(s, causal)
    want, vjp = jax.vjp(lambda a, b, c: jattn.sdpa_chunked(
        a, b, c, q_pos, k_pos, window, 32),
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)))
    _close(out, want, "out")
    jgrads = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    for g, w, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        _close(g, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96, 256])
def test_delta_is_within_the_summation_bound_of_the_exact_rowsum(dh, dtype):
    """``_delta`` (the plain version of K8's rowsum(dO∘O) kernel) against
    the float64 rowsum of the same inputs per row, within
    ``delta_tolerance``: dh·2⁻²⁴·Σ|dO∘O|, the f32 summation bound that
    the kernel is held to against ``_delta`` on the card.  A ragged S."""
    rng = np.random.default_rng(dh)
    shape = (2, 77, 3, dh)
    out, do = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
               for _ in range(2))
    got = fa._delta(out, do)
    o64, d64 = (t.float().numpy().astype(np.float64) for t in (out, do))
    exact = np.einsum("bshd,bshd->bhs", d64, o64)
    bound = np.einsum("bshd,bshd->bhs", np.abs(d64), np.abs(o64)) \
        * dh * 2.0 ** -24
    tol = fa.delta_tolerance(out, do)
    assert got.shape == tol.shape == (2, 3, 77) and got.dtype == torch.float32
    np.testing.assert_allclose(tol.numpy(), bound, rtol=1e-5)
    assert (np.abs(got.numpy() - exact) <= bound).all()
