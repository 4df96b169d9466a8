"""The port's xLSTM blocks and the xLSTM LM against the reference, on the
CPU (one process).

The same numpy inputs and parameters (the reference's initial weights,
through ``convert.params_from_numpy``) go through ``repro.models.xlstm``
/ ``ssm_lm`` and their ports at ``reduced()`` size in float32, held at
rtol 1e-4 / atol 1e-5:

* the mLSTM's sequential scan and its chunkwise form (chunks 8, 16 and
  32), outputs and final ``(C, n, m)``; the chunked form against the
  sequential one at the reference's 2e-4 (``test_xlstm_chunked.py``),
  and the rule that picks the form; decode continuing from a chunked
  prefill's state against one continuing from the sequential state;
* the sLSTM from the initial state and from a random one;
* gradients against ``jax.grad``, including inputs whose maxima tie
  (the i-gate constant, the forget gate saturated, the queries small so
  that the denominator's clamp binds): ``torch.amax`` and
  ``torch.maximum`` split the gradient among ties as ``jnp.max`` and
  ``jnp.maximum`` do;
* the LM's loss and every gradient leaf, and its layer layout.

How far rounding moves the logits at the published depth is held in
``test_torch_xlstm_depth.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.models import ssm_lm as jssm_lm
from repro.models import xlstm as jxlstm

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, ssm_lm, xlstm

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "xlstm-350m"


def _specs(**over):
    j = dataclasses.replace(jget_spec(ARCH).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(ARCH).reduced(), dtype="float32",
                            **over)
    return j, t


def _params(make, jspec, seed=0):
    jp = jax.tree_util.tree_map(np.asarray,
                                make(jax.random.PRNGKey(seed), jspec))
    return jp, params_from_numpy(jp)


def _x(spec, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, spec.d_model)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **(tol or TOL))


@pytest.mark.parametrize("chunk", [0, 8, 16, 32])
def test_mlstm_matches_reference(chunk):
    jspec, tspec = _specs(mlstm_chunk=chunk)
    jp, tp = _params(jxlstm.mlstm_params, jspec)
    x = _x(jspec, 2, 64, 1)
    jy, jst = jxlstm.mlstm_forward(jp, x, jspec)
    y, st = xlstm.mlstm_forward(tp, _t(x), tspec)
    _close(y, jy, "y")
    for k in ("c", "n", "m"):
        _close(st[k], jst[k], k)
    if chunk:
        y_seq, st_seq = xlstm.mlstm_forward(
            tp, _t(x), dataclasses.replace(tspec, mlstm_chunk=0))
        _close(y, y_seq, "chunked vs sequential", atol=2e-4, rtol=2e-4)
        for k in ("c", "n", "m"):
            _close(st[k], st_seq[k], k, atol=1e-4, rtol=1e-4)


def test_chunked_form_only_when_it_divides_and_is_shorter():
    """``s % chunk == 0 and s > chunk``: otherwise the sequential scan
    runs, bit for bit."""
    _, tspec = _specs()
    _, tp = _params(jxlstm.mlstm_params, _specs()[0])
    for s, chunk in ((64, 64), (48, 32), (16, 32)):
        x = _t(_x(tspec, 2, s, 2))
        a, _ = xlstm.mlstm_forward(
            tp, x, dataclasses.replace(tspec, mlstm_chunk=chunk))
        b, _ = xlstm.mlstm_forward(tp, x, tspec)
        assert torch.equal(a, b), (s, chunk)
    x = _t(_x(tspec, 2, 64, 2))
    a, _ = xlstm.mlstm_forward(tp, x, dataclasses.replace(tspec,
                                                          mlstm_chunk=32))
    b, _ = xlstm.mlstm_forward(tp, x, tspec)
    assert not torch.equal(a, b)


def test_chunked_state_handoff():
    """A decode step from a chunked prefill's state against one from the
    sequential state (the reference's test), and against the reference's
    step from its chunked state."""
    jspec, tspec = _specs()
    jp, tp = _params(jxlstm.mlstm_params, jspec)
    x, x2 = _x(jspec, 2, 64, 3), _x(jspec, 2, 1, 4)
    chunked = dataclasses.replace(tspec, mlstm_chunk=16)
    _, st = xlstm.mlstm_forward(tp, _t(x), chunked)
    y_a, _ = xlstm.mlstm_decode(tp, _t(x2), st, tspec)
    _, st_seq = xlstm.mlstm_forward(tp, _t(x), tspec)
    y_b, _ = xlstm.mlstm_decode(tp, _t(x2), st_seq, tspec)
    _close(y_a, y_b.numpy(), "handoff", atol=2e-4, rtol=2e-4)
    _, jst = jxlstm.mlstm_forward(
        jp, x, dataclasses.replace(jspec, mlstm_chunk=16))
    jy, _ = jxlstm.mlstm_decode(jp, x2, jst, jspec)
    _close(y_a, jy, "against the reference")


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_matches_reference(from_state):
    jspec, tspec = _specs()
    jp, tp = _params(jxlstm.slstm_params, jspec, 5)
    x = _x(jspec, 2, 24, 6)
    jst = tst = None
    if from_state:
        rng = np.random.default_rng(7)
        jst = {k: (np.abs if k == "n" else np.asarray)(
            rng.standard_normal(v.shape)).astype(np.float32) + (k == "n")
            for k, v in jxlstm.slstm_init_state(jspec, 2).items()}
        tst = {k: _t(v) for k, v in jst.items()}
    jy, jout = jxlstm.slstm_forward(jp, x, jspec, state=jst)
    y, out = xlstm.slstm_forward(tp, _t(x), tspec, state=tst)
    _close(y, jy, "y")
    for k in ("c", "n", "m", "h"):
        _close(out[k], jout[k], k)


def _tied(jp, kind):
    """Parameters whose maxima tie: the i-gate constant, the forget gate
    saturated (log-sigmoid exactly 0), the queries small (the mLSTM's
    denominator clamp binds)."""
    jp = dict(jp)
    if kind == "slstm":
        d = jp["down_proj"].shape[0]
        w_in = jp["w_in"].copy()
        w_in[:, d:2 * d] = 0.0                     # i-gate pre-activations
        jp["w_in"] = w_in
        r = jp["r_rec"].copy()
        dh = r.shape[1]
        r[:, :, dh:2 * dh] = 0.0
        jp["r_rec"] = r
        return jp
    jp["wi"] = np.zeros_like(jp["wi"])
    jp["f_bias"] = np.full_like(jp["f_bias"], 200.0)
    jp["wq"] = jp["wq"] * np.float32(0.01)
    return jp


@pytest.mark.parametrize("kind,chunk,tied", [
    ("mlstm", 0, False), ("mlstm", 16, False), ("slstm", 0, False),
    ("mlstm", 0, True), ("mlstm", 16, True), ("slstm", 0, True)])
def test_gradients_match_jax(kind, chunk, tied):
    jspec, tspec = _specs(mlstm_chunk=chunk)
    make = jxlstm.mlstm_params if kind == "mlstm" else jxlstm.slstm_params
    jfwd = jxlstm.mlstm_forward if kind == "mlstm" else jxlstm.slstm_forward
    fwd = xlstm.mlstm_forward if kind == "mlstm" else xlstm.slstm_forward
    jp, _ = _params(make, jspec, 8)
    if tied:
        jp = _tied(jp, kind)
    tp = params_from_numpy(jp)
    x = _x(jspec, 2, 32, 9)

    wy = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)

    # A token-mean loss, as the LM's cross-entropy is, of the outputs and
    # the final memory.
    def jloss(p, x):
        y, st = jfwd(p, x, jspec)
        return jnp.mean(y * wy) + jnp.mean(st["c"])

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    xt = _t(x).requires_grad_(True)
    for p in tp.values():
        p.requires_grad_(True)
    y, st = fwd(tp, xt, tspec)
    (torch.mean(y * _t(wy)) + torch.mean(st["c"])).backward()
    _close(xt.grad, jgx, "dx")
    for k, p in tp.items():
        _close(p.grad, jg[k], k)
        assert torch.isfinite(p.grad).all(), k


def test_layout_matches_reference():
    for over in ({}, {"num_layers": 7, "slstm_every": 3},
                 {"num_layers": 3, "slstm_every": 0}):
        js = dataclasses.replace(jget_spec(ARCH), **over)
        ts = dataclasses.replace(get_spec(ARCH), **over)
        assert ssm_lm._layout(ts) == jssm_lm._layout(js)
        assert ssm_lm._segments(ts) == jssm_lm._segments(js)
    assert ssm_lm._segments(get_spec(ARCH))[1:] == (21, 3)


@pytest.mark.parametrize("chunk", [0, 8])
def test_lm_loss_and_grads_match_reference(chunk):
    jspec, tspec = _specs(mlstm_chunk=chunk)
    jm = jbuild_model(jspec)
    jparams = jm.init(jax.random.PRNGKey(10))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jspec.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, batch)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, _ = build_model(tspec).loss(
        params, {k: _t(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = tree.leaves_with_path(params)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        _close(p.grad, g, "/".join(path))
