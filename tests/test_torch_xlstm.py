"""The port's xLSTM blocks and the xLSTM LM against the reference, on the
CPU (one process, ~85 s).

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
* the LM's loss and every gradient leaf, and its layer layout;
* at the published depth (24 layers, 256 wide) rounding moves the last
  logits as far in the port as in the reference: the reference's own
  chunked and sequential forms lie ~0.1 apart there, 1e-6 at 2 layers.
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


def _rel(got, want):
    """The max difference relative to the largest magnitude of ``want``
    (chip_smoke.py's measure)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("layers", [2, 24])
def test_depth_amplifies_rounding_alike(layers):
    """xlstm-350m's layout (an sLSTM every 8th block) at 256 wide, with
    the reference's weights: how far rounding moves the last logits, in
    the reference and in the port, at 2 layers and at the published 24
    (~35 s).  At 24 layers the reference's own chunked (64) and
    sequential forms lie more than 1e-2 apart in float32 and its bf16
    decode more than 0.05 from its bf16 forward; at 2 layers its forms
    agree within 1e-4 and its bf16 decode within 0.05.  The port's
    chunked and sequential forms, and its sequential form against the
    reference's, lie no farther apart than 4 times the reference's own
    forms (or 1e-5); decode = forward holds in float32 within 0.05 over
    32 + 8 tokens; and the bf16 decode lies no farther from the float32
    forward than 1.5 times the bf16 forward (chip_smoke.py's
    ``DECODE_FAITH``), in both.  Prints the readings."""
    over = dict(num_layers=layers, d_model=256, vocab_size=4096,
                dtype="float32")
    jspec = dataclasses.replace(jget_spec(ARCH), **over)
    tspec = dataclasses.replace(get_spec(ARCH), **over)
    jp = jbuild_model(jspec).init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(8).integers(
        0, jspec.vocab_size, (2, 264)).astype(np.int32)

    def run(spec, tokens, prompt=None):
        """The last logits of the forward over ``tokens`` (prefill), or
        of decode after a prefill of ``prompt`` of them: (ref, port)."""
        jm, tm = jbuild_model(spec[0]), build_model(spec[1])
        prompt = prompt or tokens.shape[1]
        jl, jc = jm.prefill(jp, {"tokens": tokens[:, :prompt]}, 0)
        with torch.inference_mode():
            tl, tc = tm.prefill(tp, {"tokens": _t(tokens[:, :prompt]).long()})
            for i in range(prompt, tokens.shape[1]):
                jl, jc = jm.decode_step(jp, jc, tokens[:, i:i + 1])
                tl, tc = tm.decode_step(tp, tc,
                                        _t(tokens[:, i:i + 1]).long())
        return np.asarray(jl, np.float32), tl.float().numpy()

    def alt(**o):
        return (dataclasses.replace(jspec, **o),
                dataclasses.replace(tspec, **o))

    f32, chk, bf16 = (jspec, tspec), alt(mlstm_chunk=64), \
        alt(dtype="bfloat16")
    seq = run(f32, toks[:, :256])
    chunked = run(chk, toks[:, :256])
    dec32, fwd32 = run(f32, toks[:, :40], 32), run(f32, toks[:, :40])
    want32 = run(f32, toks)
    dec16, fwd16 = run(bf16, toks, 256), run(bf16, toks)
    r = {"chunked vs sequential, float32 (ref, port)":
         [_rel(chunked[i], seq[i]) for i in (0, 1)],
         "port against ref, sequential": _rel(seq[1], seq[0]),
         "decode vs forward, float32, 32 + 8":
         [_rel(dec32[i], fwd32[i]) for i in (0, 1)],
         "decode vs forward, bf16, 256 + 8":
         [_rel(dec16[i], fwd16[i]) for i in (0, 1)],
         "bf16 decode, bf16 forward, from the float32 forward (ref)":
         [_rel(dec16[0], want32[0]), _rel(fwd16[0], want32[0])],
         "bf16 decode, bf16 forward, from the float32 forward (port)":
         [_rel(dec16[1], want32[1]), _rel(fwd16[1], want32[1])]}
    print(f"\n{layers} layers: {r}")
    ref_gap = max(r["chunked vs sequential, float32 (ref, port)"][0], 1e-5)
    if layers == 24:
        assert ref_gap > 1e-2
        assert r["decode vs forward, bf16, 256 + 8"][0] > 0.05
    else:
        assert ref_gap < 1e-4
        assert r["decode vs forward, bf16, 256 + 8"][0] < 0.05
    assert r["chunked vs sequential, float32 (ref, port)"][1] <= 4 * ref_gap
    assert r["port against ref, sequential"] <= 4 * ref_gap
    assert max(r["decode vs forward, float32, 32 + 8"]) < 0.05
    for who in ("ref", "port"):
        dec, fwd = r[f"bf16 decode, bf16 forward, from the float32 forward "
                     f"({who})"]
        assert dec <= 1.5 * fwd, who
