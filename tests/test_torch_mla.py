"""The port's MLA (``repro_torch/models/attention.py``: ``mla_forward``,
``mla_decode``) against the reference's on the CPU, in float32, from
the reference's initial weights of deepseek-v2-lite-16b's reduced spec
and numpy inputs (one process).

* ``mla_forward``: the output, the latents ``(c_kv, k_rope)`` and the
  gradients of ``sum(out·w)`` at rtol 1e-5 / 1e-4;
* ``mla_decode``: the output and the two caches it writes, at a slot
  inside the cache and at a position past its end (the slot clamps to
  the last, every entry valid);
* decode against forward: a cache seeded with ``mla_forward``'s latents
  of the first positions, then one token at a time, each output equal
  to ``mla_forward``'s over the whole sequence at that position.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import attention as jattn

from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(seed):
    jspec = dataclasses.replace(jget_spec(ARCH).reduced(), dtype="float32")
    tspec = dataclasses.replace(get_spec(ARCH).reduced(), dtype="float32")
    jparams = jattn.mla_params(jax.random.PRNGKey(seed), jspec)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jspec.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return jspec, tspec, jparams, params, x, pos


def test_mla_forward_matches_reference():
    jspec, tspec, jparams, params, x, pos = _setup(0)
    jout, (jc, jkr) = jax.jit(jattn.mla_forward, static_argnums=3)(
        jparams, jnp.asarray(x), jnp.asarray(pos), jspec)
    out, (c, kr) = attention.mla_forward(params, torch.from_numpy(x),
                                         torch.from_numpy(pos.copy()), tspec)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), **TOL)
    assert c.shape == (B, S, tspec.kv_lora_rank)
    assert kr.shape == (B, S, tspec.qk_rope_dim)


def test_mla_forward_gradients_match_reference():
    jspec, tspec, jparams, params, x, pos = _setup(1)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jattn.mla_forward(p, xx, jnp.asarray(pos),
                                         jspec)[0] * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams,
                                                        jnp.asarray(x))
    for p in params.values():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = attention.mla_forward(params, xt, torch.from_numpy(pos.copy()),
                                   tspec)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("pos", [13, 40])
def test_mla_decode_matches_reference(pos):
    """A cache of 32 slots with random latents; ``pos`` 13 writes slot
    13 and masks the slots after it, ``pos`` 40 (past the cache) writes
    the last slot and masks none."""
    jspec, tspec, jparams, params, x, _ = _setup(2)
    rng = np.random.default_rng(3)
    smax = 32
    cc = rng.standard_normal((B, smax, jspec.kv_lora_rank)).astype(
        np.float32)
    ckr = rng.standard_normal((B, smax, jspec.qk_rope_dim)).astype(
        np.float32)
    x1 = x[:, :1]
    jout, (jc, jkr) = jattn.mla_decode(jparams, jnp.asarray(x1),
                                       jnp.asarray(cc), jnp.asarray(ckr),
                                       jnp.int32(pos), jspec)
    tc, tkr = torch.from_numpy(cc.copy()), torch.from_numpy(ckr.copy())
    out = attention.mla_decode(params, torch.from_numpy(x1.copy()), tc, tkr,
                               pos, tspec)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **TOL)
    slot = min(pos, smax - 1)
    changed = np.nonzero((tc.numpy() != cc).any(axis=(0, 2)))[0]
    assert changed.tolist() == [slot]


def test_mla_decode_equals_forward():
    _, tspec, _, params, x, pos = _setup(4)
    xt = torch.from_numpy(x)
    full, (c, kr) = attention.mla_forward(params, xt,
                                          torch.from_numpy(pos.copy()), tspec)
    start = 16
    cache_c = torch.zeros((B, S, tspec.kv_lora_rank))
    cache_kr = torch.zeros((B, S, tspec.qk_rope_dim))
    cache_c[:, :start] = c[:, :start]
    cache_kr[:, :start] = kr[:, :start]
    for t in range(start, S):
        out = attention.mla_decode(params, xt[:, t:t + 1], cache_c, cache_kr,
                                   t, tspec)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache_c.numpy(), c.numpy(), **TOL)
    np.testing.assert_allclose(cache_kr.numpy(), kr.numpy(), **TOL)
