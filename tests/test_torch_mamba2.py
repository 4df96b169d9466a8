"""The port's Mamba2 block and the zamba2 hybrid against the reference,
on the CPU (one process, ~35 s).

The same numpy inputs and parameters (the reference's initial weights,
carried over by ``convert.params_from_numpy``) go through
``repro.models.mamba2`` / ``hybrid`` and their ports, at ``reduced()``
size in float32, held at rtol 1e-4 / atol 1e-5 (the reference's own
``test_mamba2_chunk_invariance`` tolerance: ``softplus`` and ``cumsum``
round differently in the two libraries):

* ``mamba2_forward`` (output and the decode state) from a random
  initial state, at a sequence of several chunks and one shorter than a
  chunk; then ``mamba2_decode`` step by step from that state;
* chunk invariance (16 against 64), and the divisibility rule;
* the hybrid's group bounds (the tail group at depth 38), its loss and
  every gradient leaf (the shared block's weights take one gradient
  contribution per application), with a tail group too;
* a steep decay (``exp`` of the masked exponents would overflow without
  the mask before ``exp``): finite gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, hybrid, mamba2

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "zamba2-1.2b"


def _specs(**over):
    j = dataclasses.replace(jget_spec(ARCH).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(ARCH).reduced(), dtype="float32",
                            **over)
    return j, t


def _mixer(jspec, seed=0):
    jp = jmamba2.mamba2_params(jax.random.PRNGKey(seed), jspec)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    # non-trivial skip, bias and norm scale
    jp["dt_bias"] = rng.standard_normal(jp["dt_bias"].shape).astype(
        np.float32)
    jp["norm_scale"] = (0.1 * rng.standard_normal(
        jp["norm_scale"].shape)).astype(np.float32)
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(
        np.float32)
    return jp, params_from_numpy(jp)


def _x(spec, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, spec.d_model)).astype(np.float32)


def _state(spec, b, seed):
    d_inner, h, p, n = mamba2.mamba2_dims(spec)
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((b, h, n, p))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seq", [48, 8])
def test_forward_matches_reference(seq):
    jspec, tspec = _specs()
    jp, tp = _mixer(jspec)
    x, h0 = _x(jspec, 2, seq, 1), _state(jspec, 2, 2)
    jy, jst = jmamba2.mamba2_forward(jp, x, jspec, h0=h0)
    y, st = mamba2.mamba2_forward(tp, _t(x), tspec, h0=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **TOL)


def test_decode_matches_reference():
    """Four one-token steps from the forward's state; the port writes the
    conv window and the SSM state in place."""
    jspec, tspec = _specs()
    jp, tp = _mixer(jspec, 3)
    x = _x(jspec, 2, 36, 4)
    _, jst = jmamba2.mamba2_forward(jp, x[:, :32], jspec)
    _, st = mamba2.mamba2_forward(tp, _t(x[:, :32]), tspec)
    st = {k: v.clone() for k, v in st.items()}
    buffers = dict(st)
    for t in range(32, 36):
        jy, jst = jmamba2.mamba2_decode(jp, x[:, t:t + 1], jst, jspec)
        y, st = mamba2.mamba2_decode(tp, _t(x[:, t:t + 1]), st, tspec)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   err_msg=f"step {t}", **TOL)
    for k in ("ssm", "conv"):
        assert st[k] is buffers[k]
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **TOL)


def test_chunk_invariance_and_divisibility():
    _, tspec = _specs()
    _, tp = _mixer(dataclasses.replace(jget_spec(ARCH).reduced(),
                                       dtype="float32"))
    x = _t(_x(tspec, 2, 64, 5))
    y1, st1 = mamba2.mamba2_forward(
        tp, x, dataclasses.replace(tspec, ssm_chunk=16))
    y2, st2 = mamba2.mamba2_forward(
        tp, x, dataclasses.replace(tspec, ssm_chunk=64))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st1["ssm"].numpy(), st2["ssm"].numpy(),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="ssm_chunk"):
        mamba2.mamba2_forward(tp, x[:, :40], tspec)


def test_group_bounds_match_reference():
    for over in ({}, {"num_layers": 5, "attn_every": 2}):
        js = dataclasses.replace(jget_spec(ARCH), **over)
        ts = dataclasses.replace(get_spec(ARCH), **over)
        assert hybrid._group_bounds(ts) == jhybrid._group_bounds(js)
        assert hybrid._n_apps(ts) == jhybrid._n_apps(js)
    assert hybrid._group_bounds(get_spec(ARCH))[-1] == (36, 38)


@pytest.mark.parametrize("over", [{}, {"num_layers": 3, "attn_every": 2}])
def test_hybrid_loss_and_grads_match_reference(over):
    jspec, tspec = _specs(**over)
    jm = jbuild_model(jspec)
    jparams = jm.init(jax.random.PRNGKey(6))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jspec.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, batch)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, met = build_model(tspec).loss(
        params, {k: _t(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["ce"].detach()) == float(loss.detach())
    got = tree.leaves_with_path(params)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   err_msg="/".join(path), **TOL)


def test_steep_decay_gradients_finite():
    """Large ``A`` and ``dt``: the masked exponents reach thousands; the
    mask before ``exp`` keeps the forward and every gradient finite, as
    in the reference."""
    jspec, tspec = _specs()
    jp, tp = _mixer(jspec, 8)
    tp["a_log"] = torch.full_like(tp["a_log"], 6.0)
    tp["dt_bias"] = torch.full_like(tp["dt_bias"], 8.0)
    for p in tp.values():
        p.requires_grad_(True)
    y, _ = mamba2.mamba2_forward(tp, _t(_x(tspec, 2, 32, 9)), tspec)
    torch.sum(y * y).backward()
    assert torch.isfinite(y).all()
    for k, p in tp.items():
        assert torch.isfinite(p.grad).all(), k
    jp["a_log"] = np.full_like(jp["a_log"], 6.0)
    jp["dt_bias"] = np.full_like(jp["dt_bias"], 8.0)
    jy, _ = jmamba2.mamba2_forward(jp, _x(jspec, 2, 32, 9), jspec)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    assert jnp.isfinite(jy).all()
