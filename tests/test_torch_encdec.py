"""The port's encoder-decoder (whisper-tiny) and its LayerNorm against
the reference, on the CPU (one process, ~15 s).

The same numpy inputs and parameters (the reference's initial weights,
through ``convert.params_from_numpy``) go through
``repro.models.encdec`` / ``common`` and their ports, at ``reduced()``
size in float32 unless stated, held at rtol 1e-4 / atol 1e-5:

* ``layernorm`` (scale and bias random, with and without bias; f32 and
  bf16 inputs, bf16 within one bf16 ulp) and ``norm`` / ``norm_params``
  for ``"layernorm"``;
* ``sinusoidal_positions`` bit for bit (both compute it in numpy), and
  any window of its rows equal to the whole table's;
* ``encode`` (the bidirectional encoder: ``sdpa_full`` with every query
  at the last position), ``decoder_forward``'s logits, at the encoder's
  32 frames and at 96 decoder tokens (the decoder's flash path above the
  reduced ``attn_full_seq_max`` of 64, rope off);
* the loss and every gradient leaf, frames included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import encdec as jencdec

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, common, encdec

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "whisper-tiny"


def _specs(**over):
    j = dataclasses.replace(jget_spec(ARCH).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(ARCH).reduced(), dtype="float32",
                            **over)
    return j, t


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("with_bias", [True, False])
def test_layernorm_matches_reference(with_bias):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 7, 384)) + 1.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(384)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(384)).astype(np.float32) \
        if with_bias else None
    want = jcommon.layernorm(x, scale, bias)
    got = common.layernorm(_t(x), _t(scale),
                           None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jcommon.layernorm(xb, scale, bias)
    got = common.layernorm(_t(x).to(torch.bfloat16), _t(scale),
                           None if bias is None else _t(bias))
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    assert _bf16_ulps(got, want_t) <= 1


def test_norm_params_and_dispatch():
    p = common.norm_params(8, "layernorm")
    assert torch.equal(p["scale"], torch.ones(8))
    assert torch.equal(p["bias"], torch.zeros(8))
    jp = jcommon.norm_params(8, "layernorm")
    assert sorted(p) == sorted(jp)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(common.norm(x, p, "layernorm"),
                       common.layernorm(x, p["scale"], p["bias"]))
    with pytest.raises(ValueError, match="unknown norm"):
        common.norm_params(8, "batchnorm")


def test_sinusoidal_positions_bit_for_bit():
    for seq, dim in ((1500, 384), (32, 256), (7, 10)):
        want = np.asarray(jcommon.sinusoidal_positions(seq, dim))
        got = common.sinusoidal_positions(seq, dim)
        assert got.dtype == np.float32
        assert np.array_equal(got, want), (seq, dim)
    full = common.sinusoidal_positions(4160, 384)
    assert np.array_equal(common.sinusoidal_positions(4097, 384, 4096),
                          full[4096:4097])


def _setup(seed, **over):
    jspec, tspec = _specs(**over)
    jparams = jbuild_model(jspec).init(jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, jspec.encoder_seq,
                                  jspec.d_model)).astype(np.float32)
    return jspec, tspec, jparams, params, frames, rng


@pytest.mark.parametrize("seq", [16, 96])
def test_encode_and_decoder_forward_match_reference(seq):
    jspec, tspec, jparams, params, frames, rng = _setup(1)
    toks = rng.integers(0, jspec.vocab_size, (2, seq)).astype(np.int32)
    jenc = jencdec.encode(jparams, frames, jspec)
    with torch.inference_mode():
        enc = encdec.encode(params, _t(frames), tspec)
        logits = encdec.decoder_forward(params, _t(toks).long(), enc, tspec)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc),
                               err_msg="encode", **TOL)
    jlogits, _, _ = jencdec.decoder_forward(jparams, toks, jenc, jspec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               err_msg="decoder", **TOL)


def test_loss_and_grads_match_reference():
    jspec, tspec, jparams, params, frames, rng = _setup(2)
    toks = rng.integers(0, jspec.vocab_size, (2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": frames}
    jm = jbuild_model(jspec)

    def jloss(p, frames):
        return jm.loss(p, {**batch, "frames": frames})[0]

    jl, (jg, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jparams, frames)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    ft = _t(frames).requires_grad_(True)
    loss, met = build_model(tspec).loss(params, {
        "tokens": _t(batch["tokens"]).long(),
        "labels": _t(batch["labels"]).long(), "frames": ft})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jgf),
                               err_msg="frames", **TOL)
    got = tree.leaves_with_path(params)
    want = jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   err_msg="/".join(path), **TOL)
