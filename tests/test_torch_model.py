"""The port's dense transformer against the reference's, on the CPU.

The reduced smollm-360m with the reference's own initial weights
(carried over by ``convert.params_from_numpy``) and one numpy batch:
logits, loss and every gradient leaf agree at rtol 1e-4 / atol 1e-5 in
float32 (the two frameworks sum in different orders); in the bfloat16
compute dtype the loss agrees to 2e-2.  At seq 128, above the reduced
spec's ``attn_full_seq_max`` of 64, both models take their flash path
(the port's ``FlashAttnFn`` runs its chunked plain versions on the CPU)
and agree at the same tolerances.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model, transformer


def _specs(dtype):
    j = dataclasses.replace(jget_spec("smollm-360m").reduced(), dtype=dtype)
    t = dataclasses.replace(get_spec("smollm-360m").reduced(), dtype=dtype)
    return j, t


def _batch(spec, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, spec.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def reference_f32():
    jspec, _ = _specs("float32")
    model = jbuild_model(jspec)
    params = model.init(jax.random.PRNGKey(0))
    batch = _batch(jspec)
    logits = jtransformer.forward(params, batch["tokens"], jspec)[0]
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "batch": batch, "logits": np.asarray(logits),
            "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_params(np_params):
    params = params_from_numpy(np_params, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return params


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_convert_roundtrip(reference_f32):
    back = params_to_numpy(params_from_numpy(reference_f32["params"]))
    for a, b in zip(tree.leaves(back), tree.leaves(reference_f32["params"])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_logits_match_reference(reference_f32):
    _, tspec = _specs("float32")
    params = _port_params(reference_f32["params"])
    with torch.no_grad():
        logits = transformer.forward(
            params, _torch_batch(reference_f32["batch"])["tokens"], tspec)
    np.testing.assert_allclose(logits.numpy(), reference_f32["logits"],
                               rtol=1e-4, atol=1e-5)


def test_loss_and_grads_match_reference(reference_f32):
    _, tspec = _specs("float32")
    model = build_model(tspec)
    params = _port_params(reference_f32["params"])
    loss, metrics = model.loss(params, _torch_batch(reference_f32["batch"]))
    loss.backward()
    assert abs(float(loss.detach()) - reference_f32["loss"]) <= \
        1e-4 * abs(reference_f32["loss"])
    assert float(metrics["aux"]) == 0.0
    got = tree.leaves_with_path(params)
    want = tree.leaves(reference_f32["grads"])
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(path))


def test_bf16_loss_matches_reference():
    jspec, tspec = _specs("bfloat16")
    model = jbuild_model(jspec)
    params = model.init(jax.random.PRNGKey(1))
    batch = _batch(jspec, seed=1)
    want = float(model.loss(params, batch)[0])
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = float(build_model(tspec).loss(tparams, _torch_batch(batch))[0])
    assert abs(got - want) <= 2e-2 * abs(want)


def test_module_holds_the_reference_names(reference_f32):
    _, tspec = _specs("float32")
    module = transformer.TransformerLM(
        tspec, params_from_numpy(reference_f32["params"]))
    names = sorted(n for n, _ in module.named_parameters())
    want = sorted("params." + ".".join(path) for path, _ in
                  tree.leaves_with_path(reference_f32["params"]))
    assert names == want
    loss, _ = module(_torch_batch(reference_f32["batch"]))
    assert abs(float(loss.detach()) - reference_f32["loss"]) <= \
        1e-4 * abs(reference_f32["loss"])


def test_long_sequences_raise_until_flash_kernels_land():
    """The flash kernels have landed: a sequence one past
    ``attn_full_seq_max`` no longer raises but takes the flash path, and
    gives the logits of plain attention at that length."""
    _, tspec = _specs("float32")
    params = transformer.init_params(torch.Generator().manual_seed(0), tspec,
                                     "cpu")
    s = tspec.attn_full_seq_max + 1
    toks = torch.randint(0, tspec.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        flash = transformer.forward(params, toks, tspec)
        plain = transformer.forward(params, toks, dataclasses.replace(
            tspec, attn_full_seq_max=s))
    assert torch.isfinite(flash).all()
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.fixture(scope="module")
def reference_long():
    """The reference at seq 128, above the reduced spec's
    ``attn_full_seq_max`` of 64: its chunked flash path (chunk 16)."""
    jspec, _ = _specs("float32")
    assert 128 > jspec.attn_full_seq_max
    model = jbuild_model(jspec)
    params = model.init(jax.random.PRNGKey(2))
    batch = _batch(jspec, b=1, s=128, seed=2)
    logits = jtransformer.forward(params, batch["tokens"], jspec)[0]
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "batch": batch, "logits": np.asarray(logits),
            "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def test_long_context_logits_match_reference(reference_long):
    _, tspec = _specs("float32")
    params = _port_params(reference_long["params"])
    with torch.no_grad():
        logits = transformer.forward(
            params, _torch_batch(reference_long["batch"])["tokens"], tspec)
    np.testing.assert_allclose(logits.numpy(), reference_long["logits"],
                               rtol=1e-4, atol=1e-5)


def test_long_context_loss_and_grads_match_reference(reference_long):
    _, tspec = _specs("float32")
    params = _port_params(reference_long["params"])
    loss, _ = build_model(tspec).loss(params,
                                      _torch_batch(reference_long["batch"]))
    loss.backward()
    assert abs(float(loss.detach()) - reference_long["loss"]) <= \
        1e-4 * abs(reference_long["loss"])
    got = tree.leaves_with_path(params)
    want = tree.leaves(reference_long["grads"])
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(path))
