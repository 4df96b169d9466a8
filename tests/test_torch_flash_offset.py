"""K7/K8's plain versions with a query offset, on the CPU (no ranks).

A model rank under sequence parallelism attends with its chunk of the
queries, at positions ``q_offset ..``, against every key
(``models/attention.py``).  On the same numpy inputs:

* the offset plain versions (``flash_fwd_plain`` / ``flash_bwd_plain``
  with ``q_offset``) give the square plain versions' rows ``q_offset ..``
  of the output and the log-sum-exp, and of dq, and the dk and dv of the
  square call whose upstream gradient is zero on the rows before
  ``q_offset``; bit for bit when the offset is a multiple of the chunk;
* the port's ``sdpa_chunked`` with the offset (kv heads repeated, then
  ``FlashAttnFn``) against the reference's ``sdpa_chunked`` given those
  query positions, forward and ``jax.vjp``, causal, windowed and
  non-causal, at the reference's tolerances (f32 forward atol 2e-5 /
  rtol 1e-4, backward 2e-3);
* a sequence that the model ranks do not divide raises, naming both
  numbers.

A few seconds alone.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn
from repro_torch.models.common import SeqSplit

FWD = dict(atol=2e-5, rtol=1e-4)
BWD = dict(atol=2e-3, rtol=2e-3)
S, CHUNK = 96, 16


def _inputs(heads, kv_heads, seed, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, heads, dh)).astype(np.float32)
    k = rng.standard_normal((1, S, kv_heads, dh)).astype(np.float32)
    v = rng.standard_normal((1, S, kv_heads, dh)).astype(np.float32)
    do = rng.standard_normal((1, S, heads, dh)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("offset", [48, 40])
@pytest.mark.parametrize("causal, window", [(True, 0), (True, 24),
                                            (False, 0)])
def test_offset_rows_are_the_square_calls_rows(offset, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 3, 1))
    kw = dict(causal=causal, window=window, chunk=CHUNK)
    out, lse = fa.flash_fwd_plain(q, k, v, **kw)
    do_part = do.clone()
    do_part[:, :offset] = 0
    grads = fa.flash_bwd_plain(q, k, v, out, lse, do_part, **kw)
    qo, doo = q[:, offset:].contiguous(), do[:, offset:].contiguous()
    oout, olse = fa.flash_fwd_plain(qo, k, v, q_offset=offset, **kw)
    ograds = fa.flash_bwd_plain(qo, k, v, oout, olse, doo, q_offset=offset,
                                **kw)
    want = (out[:, offset:], lse[..., offset:], grads[0][:, offset:],
            grads[1], grads[2])
    got = (oout, olse, *ograds)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    for a, b in zip(got, want):
        if offset % CHUNK == 0:
            # the same chunks of queries, in the same order
            assert torch.equal(a, b), (a - b).abs().max()
        else:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 24),
                                            (False, 0)])
def test_offset_chunked_attention_matches_reference(causal, window):
    q, k, v, do = _inputs(4, 2, 2)
    offset = 40
    qo, doo = q[:, offset:], do[:, offset:]
    # Non-causal: every query past the last key, as the reference's
    # non-causal call is reached.
    q_pos = jnp.arange(offset, S, dtype=jnp.int32) if causal \
        else jnp.full((S - offset,), 10 * S, dtype=jnp.int32)
    k_pos = jnp.arange(S, dtype=jnp.int32)

    def ref(q_, k_, v_):
        return jattn.sdpa_chunked(q_, k_, v_, q_pos, k_pos, window, CHUNK)

    want, vjp = jax.vjp(ref, jnp.asarray(qo), jnp.asarray(k),
                        jnp.asarray(v))
    wgrads = vjp(jnp.asarray(doo))
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a))
                  .requires_grad_(True) for a in (qo, k, v))
    if causal:
        got = tattn.sdpa_chunked(tq, tk, tv, window, CHUNK, offset)
    else:
        rep = tq.shape[2] // tk.shape[2]
        got = fa.FlashAttnFn.apply(
            tq, torch.repeat_interleave(tk, rep, 2),
            torch.repeat_interleave(tv, rep, 2), False, window, CHUNK,
            offset)
    got.backward(torch.from_numpy(np.ascontiguousarray(doo)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    for t, g in zip((tq, tk, tv), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BWD)


def test_offset_must_not_be_negative():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 2, 3))
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_fwd(q, k, v, q_offset=-1)


def test_uneven_sequence_raises_naming_both_numbers():
    group = types.SimpleNamespace(size=3, rank=1)
    with pytest.raises(ValueError, match="100 positions.*3 model ranks"):
        SeqSplit.of(group, 100)
    split = SeqSplit.of(group, 99)
    assert (split.offset, split.length, split.total) == (33, 33, 99)
    assert split.positions(2, "cpu").tolist() == [list(range(33, 66))] * 2
