"""The rest of the transformer family against the reference, on the CPU:
granite-moe-1b-a400m (MoE), deepseek-v2-lite-16b (MLA, a dense prefix
layer, MoE with shared experts) and phi-3-vision-4.2b (the VLM backbone,
image patches before the text).  One process.

* the port's spec equals the reference's field by field, full and
  reduced; ``param_pspecs`` (the experts sharded on their expert dim,
  the shared experts and the prefix as dense layers) and
  ``divisibility_check`` equal the reference's at full size (shapes
  only: the reference's ``eval_shape``, the port's meta tensors);
* at ``reduced()`` size in float32, from the reference's own initial
  weights: the loss, ``ce``, ``aux`` and ``drop`` and every gradient
  leaf at rtol 1e-4 / atol 1e-5;
* prefill (caches of the prefix and the body, MLA's latents) and four
  teacher-forced decode steps at ``capacity_factor`` 8.0 (the
  reference's no-drop factor) at the same tolerance;
* F8: the port's ``prefill`` refuses a non-windowed cache smaller than
  the prompt with its patches, and ``launch/serve.py::build_engine``
  sizes the VLM's cache with them: its engine's greedy tokens equal the
  reference's model functions run on a cache sized so.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model
from repro.models import divisibility_check as jdivisibility_check
from repro.models import param_pspecs as jparam_pspecs

from repro_torch import tree
from repro_torch.configs import get_spec, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import extra_inputs
from repro_torch.launch.serve import build_engine, parser
from repro_torch.models import (build_model, divisibility_check,
                                param_pspecs, transformer)

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "phi-3-vision-4.2b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _fields(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def _specs(arch, **over):
    j = dataclasses.replace(jget_spec(arch).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(arch).reduced(), dtype="float32",
                            **over)
    return j, t


def _np(x):
    return np.asarray(x, np.float32)


def _ref_params(jspec, seed):
    jparams = jbuild_model(jspec).init(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def _batch(spec, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, spec.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if spec.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, spec.num_image_tokens, spec.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch):
    assert arch in list_archs()
    for j, t in ((jget_spec(arch), get_spec(arch)),
                 (jget_spec(arch).reduced(), get_spec(arch).reduced())):
        assert _fields(t) == _fields(j)
        assert t.resolved_head_dim == j.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_pspecs_and_divisibility_match_reference(arch):
    jspec, tspec = jget_spec(arch), get_spec(arch)
    shapes = jax.eval_shape(jbuild_model(jspec).init, jax.random.PRNGKey(0))
    meta = build_model(tspec).init(torch.Generator(), "meta").tree()
    got = tree.leaves_with_path(param_pspecs(meta))
    want = jax.tree_util.tree_leaves_with_path(
        jparam_pspecs(shapes), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    assert len(got) == len(want)
    for (path, spec), (jpath, jspec_) in zip(got, want):
        assert list(path) == [k.key for k in jpath]
        assert spec == tuple(jspec_), "/".join(path)
    for (path, x), s in zip(tree.leaves_with_path(meta),
                            jax.tree_util.tree_leaves(shapes)):
        assert tuple(x.shape) == tuple(s.shape), "/".join(path)
    for m in (2, 4, 16):
        assert sorted(divisibility_check(meta, m)) == sorted(
            (p, tuple(s)) for p, s in jdivisibility_check(shapes, m))
    if tspec.num_experts:
        assert param_pspecs(meta)["body"]["moe"]["w1"] == \
            (None, "model", None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_metrics_and_grads_match_reference(arch):
    jspec, tspec = _specs(arch)
    jparams, params = _ref_params(jspec, ARCHS.index(arch))
    batch = _batch(jspec, 2, 32, seed=ARCHS.index(arch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jbuild_model(jspec).loss, has_aux=True))(jparams, batch)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, met = build_model(tspec).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("ce", "aux", "drop"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    if tspec.num_experts:
        assert float(met["aux"].detach()) > 0.0
    got = tree.leaves_with_path(params)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                   err_msg="/".join(path), **TOL)
    assert ("prefix" in params) == bool(tspec.first_dense_layers)


def _compare_cache(cache, jcache, what):
    for part in ("body", "prefix"):
        assert (part in cache) == (part in jcache), part
        if part in cache:
            for k in ("k", "v"):
                np.testing.assert_allclose(
                    cache[part][k].numpy(), _np(jcache[part][k]),
                    err_msg=f"{what} {part} {k}", **TOL)
    assert int(cache["pos"]) == int(jcache["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jspec, tspec = _specs(arch, capacity_factor=8.0)
    jparams, params = _ref_params(jspec, 10 + ARCHS.index(arch))
    b, prompt, steps = 2, 8, 4
    data = _batch(jspec, b, prompt + steps, seed=20)
    toks = data["tokens"]
    extra = {"patches": data["patches"]} if "patches" in data else {}
    n_img = jspec.num_image_tokens if extra else 0
    max_seq = n_img + prompt + steps
    jmodel, model = jbuild_model(jspec), build_model(tspec)
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": toks[:, :prompt], **extra}, max_seq)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {
            "tokens": torch.from_numpy(toks[:, :prompt]),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}, max_seq)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                               err_msg="prefill logits", **TOL)
    _compare_cache(cache, jcache, "prefill")
    assert int(cache["pos"]) == n_img + prompt
    if tspec.attention_type == "mla":
        assert cache["body"]["k"].shape[-1] == tspec.kv_lora_rank
    for t in range(prompt, prompt + steps):
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             toks[:, t:t + 1])
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits),
                                   err_msg=f"decode at {t}", **TOL)
    _compare_cache(cache, jcache, "final")


def test_vlm_patches_come_first():
    """``extra_inputs``: bf16 patches of the spec's image tokens, seeded;
    the logits of the text positions follow the patches'."""
    _, tspec = _specs("phi-3-vision-4.2b")
    a, b = extra_inputs(tspec, 2, seed=3), extra_inputs(tspec, 2, seed=3)
    assert a["patches"].shape == (2, tspec.num_image_tokens, tspec.d_model)
    assert a["patches"].dtype == torch.bfloat16
    assert torch.equal(a["patches"].view(torch.int16),
                       b["patches"].view(torch.int16))
    assert extra_inputs(get_spec("granite-moe-1b-a400m"), 2) == {}
    params = build_model(tspec).init(torch.Generator().manual_seed(0),
                                     "cpu").tree()
    toks = torch.zeros((2, 5), dtype=torch.int64)
    with torch.inference_mode():
        logits = transformer.forward(params, toks, tspec,
                                     patches=a["patches"])
    assert logits.shape[1] == tspec.num_image_tokens + 5


def test_prefill_refuses_a_cache_without_room_for_the_patches():
    """F8: 8 patches + 8 tokens do not fit 13 slots (the reference's
    engine sizing, ``prompt + new + 1``); a windowed spec keeps its
    trailing window as before."""
    _, tspec = _specs("phi-3-vision-4.2b")
    model = build_model(tspec)
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64),
             **extra_inputs(tspec, 2)}
    with torch.inference_mode(), pytest.raises(ValueError, match="patches"):
        model.prefill(params, batch, 13)
    windowed = dataclasses.replace(tspec, sliding_window=4)
    with torch.inference_mode():
        _, cache = build_model(windowed).prefill(params, batch, 13)
    assert cache["body"]["k"].shape[2] == 4
    assert int(cache["pos"]) == 16


def test_engine_sizes_the_vlm_cache_with_its_patches():
    """The port's engine (``build_engine``: max_seq = patches + prompt +
    new + 1) against the reference's prefill and decode steps on a cache
    sized with the patches, from the same weights and batch: the same
    greedy tokens."""
    jspec, tspec = _specs("phi-3-vision-4.2b")
    jparams, params = _ref_params(jspec, 7)
    args = parser().parse_args(["--arch", "phi-3-vision-4.2b", "--mesh",
                                "1x1", "--device", "cpu", "--batch", "2",
                                "--prompt-len", "8", "--new-tokens", "4"])
    engine, batch = build_engine(args, spec=tspec)
    n_img = jspec.num_image_tokens
    assert engine.cfg.max_seq == n_img + 8 + 4 + 1
    engine.params = params
    out = engine.generate(batch)
    jmodel = jbuild_model(jspec)
    jbatch = {"tokens": batch["tokens"].numpy().astype(np.int32),
              "patches": batch["patches"].float().numpy()}
    logits, cache = jmodel.prefill(jparams, jbatch, engine.cfg.max_seq)
    want = []
    for _ in range(4):
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))
        logits, cache = jmodel.decode_step(jparams, cache, tok[:, None])
    assert np.array_equal(out, np.stack(want, axis=1))
    # the generation is refused when the cache has no room for the patches
    engine.cfg = types.SimpleNamespace(**{**vars(engine.cfg),
                                          "max_seq": 8 + 4 + 1})
    with pytest.raises(ValueError, match="image patches"):
        engine.generate(batch)
