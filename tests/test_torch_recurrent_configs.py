"""The recurrent and encoder-decoder families and ``remat`` against the
reference, on the CPU (one process, ~60 s): zamba2-1.2b (the Mamba2
hybrid), xlstm-350m (mLSTM + sLSTM) and whisper-tiny (encoder-decoder,
LayerNorm).

* the port's specs equal the reference's field by field, full and
  reduced, and the port builds every arch the reference lists;
* at full size (the reference's ``eval_shape``, the port's meta
  tensors): ``param_pspecs`` (the Mamba2 and xLSTM rules) and
  ``divisibility_check`` equal the reference's, and so do the serving
  caches' shapes and ``cache_pspecs`` (the 5-d SSM states prefer dim 3,
  as the reference's attention-cache branch does) on three meshes;
* at ``reduced()`` size in float32 from the reference's own weights,
  held at rtol 1e-4 / atol 1e-5: the prefill's last logits and every
  cache leaf, then 4 teacher-forced decode steps and the final cache;
  the engine's greedy tokens (``build_engine`` on the host, whisper's
  frames from ``extra_inputs``) equal the reference's model functions;
* one checkpoint each way: the port's file of each reduced tree restores
  through ``repro.checkpoint`` and the reference's through the port's;
* ``remat=True``: loss and every gradient bit for bit ``remat=False`` in
  the port (reduced smollm-360m at 96 tokens, its flash path), and within
  the tolerance of the reference's ``remat=True``; a ``seq_parallel``
  spec without a sequence group gives the plain spec's loss and
  gradients bit for bit.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from repro import checkpoint as jckpt
from repro.configs import get_spec as jget_spec
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild_model
from repro.models import divisibility_check as jdivisibility_check
from repro.models import param_pspecs as jparam_pspecs
from repro.serve.sharding import cache_pspecs as j_cache_pspecs

from repro_torch import checkpoint, tree
from repro_torch.configs import get_spec, list_archs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.serve import build_engine, parser
from repro_torch.models import build_model, divisibility_check, param_pspecs
from repro_torch.serve.sharding import cache_pspecs

ARCHS = ["zamba2-1.2b", "xlstm-350m", "whisper-tiny"]
TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4},
          "2x16": {"data": 2, "model": 16}}


def _fields(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def _specs(arch, **over):
    j = dataclasses.replace(jget_spec(arch).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(arch).reduced(), dtype="float32",
                            **over)
    return j, t


def _ref_params(jspec, seed):
    jparams = jbuild_model(jspec).init(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def _paths(jtree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=is_leaf)[0]}


def _port_paths(ttree):
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree.leaves_with_path(ttree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch):
    assert arch in list_archs()
    for j, t in ((jget_spec(arch), get_spec(arch)),
                 (jget_spec(arch).reduced(), get_spec(arch).reduced())):
        assert _fields(t) == _fields(j)


def test_every_reference_arch_builds():
    assert list_archs() == jlist_archs()
    for arch in list_archs():
        spec = get_spec(arch).reduced()
        model = build_model(spec)
        assert model.init(torch.Generator(), "meta").tree()
        assert model.init_cache(2, 16, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_pspecs_and_divisibility_match_reference(arch):
    jspec, tspec = jget_spec(arch), get_spec(arch)
    shapes = jax.eval_shape(jbuild_model(jspec).init, jax.random.PRNGKey(0))
    meta = build_model(tspec).init(torch.Generator(), "meta").tree()
    got = tree.leaves_with_path(param_pspecs(meta))
    want = jax.tree_util.tree_leaves_with_path(
        jparam_pspecs(shapes), is_leaf=lambda x: isinstance(x, P))
    assert len(got) == len(want)
    for (path, spec), (jpath, jspec_) in zip(got, want):
        assert list(path) == [k.key for k in jpath]
        assert spec == tuple(jspec_), "/".join(path)
    for (path, x), s in zip(tree.leaves_with_path(meta),
                            jax.tree_util.tree_leaves(shapes)):
        assert tuple(x.shape) == tuple(s.shape), "/".join(path)
    n = sum(x.numel() for x in tree.leaves(meta))
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
    for m in (2, 4, 16):
        assert sorted(divisibility_check(meta, m)) == sorted(
            (p, tuple(s)) for p, s in jdivisibility_check(shapes, m))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_cache_pspecs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    dp_axes = ("data",)
    jmodel = jbuild_model(jget_spec(arch))
    tpl = jax.eval_shape(lambda: jmodel.init_cache(4, 4160))
    meta = build_model(get_spec(arch)).init_cache(4, 4160, device="meta")
    want_shapes = _paths(tpl)
    got_shapes = _port_paths(meta)
    assert sorted(got_shapes) == sorted(want_shapes)
    for k, x in got_shapes.items():
        assert tuple(x.shape) == tuple(want_shapes[k].shape), k
        assert x.dtype == getattr(torch, str(want_shapes[k].dtype)), k
    want = _paths(j_cache_pspecs(tpl, types.SimpleNamespace(shape=sizes),
                                 dp_axes), is_leaf=lambda x: isinstance(x, P))
    got = {k: P(*s) for k, s in _port_paths(cache_pspecs(
        meta, {ax: types.SimpleNamespace(size=n) for ax, n in sizes.items()},
        dp_axes)).items()}
    assert got == want


def _compare_cache(cache, jcache, what):
    got, want = _port_paths(cache), _paths(jcache)
    assert sorted(got) == sorted(want), what
    for k, x in got.items():
        if k == "pos":
            assert int(x) == int(want[k])
            continue
        np.testing.assert_allclose(x.float().numpy(), np.asarray(
            want[k], np.float32), err_msg=f"{what} {k}", **TOL)


def _inputs(jspec, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jspec.vocab_size, (b, s)).astype(np.int32)
    extra = {}
    if jspec.family == "audio":
        extra["frames"] = rng.standard_normal(
            (b, jspec.encoder_seq, jspec.d_model)).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jspec, tspec = _specs(arch)
    jparams, params = _ref_params(jspec, 10 + ARCHS.index(arch))
    b, prompt, steps = 2, 16, 4          # zamba2: prompt = its ssm_chunk
    toks, extra = _inputs(jspec, b, prompt + steps, 20)
    max_seq = prompt + steps
    jmodel, model = jbuild_model(jspec), build_model(tspec)
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": toks[:, :prompt], **extra}, max_seq)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {
            "tokens": torch.from_numpy(toks[:, :prompt]).long(),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}, max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               err_msg="prefill logits", **TOL)
    _compare_cache(cache, jcache, "prefill")
    for t in range(prompt, prompt + steps):
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             toks[:, t:t + 1])
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"decode at {t}", **TOL)
    _compare_cache(cache, jcache, "final")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(arch):
    jspec, tspec = _specs(arch)
    jparams, params = _ref_params(jspec, 30 + ARCHS.index(arch))
    args = parser().parse_args(["--arch", arch, "--mesh", "1x1", "--device",
                                "cpu", "--batch", "2", "--prompt-len", "16",
                                "--new-tokens", "5"])
    engine, batch = build_engine(args, spec=tspec)
    # text tokens only: the frames feed the encoder, not the cache
    assert engine.cfg.max_seq == 16 + 5 + 1
    assert ("frames" in batch) == (tspec.family == "audio")
    engine.params = params
    out = engine.generate(batch)
    jmodel = jbuild_model(jspec)
    jbatch = {k: v.float().numpy() if v.is_floating_point()
              else v.numpy().astype(np.int32) for k, v in batch.items()}
    logits, cache = jmodel.prefill(jparams, jbatch, engine.cfg.max_seq)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))
        logits, cache = jmodel.decode_step(jparams, cache, tok[:, None])
    assert np.array_equal(out, np.stack(want, axis=1))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_each_way(tmp_path, arch, writer):
    jspec, _ = _specs(arch)
    jparams, params = _ref_params(jspec, 40)
    if writer == "port":
        checkpoint.save(str(tmp_path), 3, params)
        out = jckpt.restore(str(tmp_path), 3, jax.tree_util.tree_map(
            jnp.zeros_like, jparams))
        for (k, a), b in zip(_paths(jparams).items(),
                             jax.tree_util.tree_leaves(out)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
    else:
        jckpt.save(str(tmp_path), 3, jparams)
        out = checkpoint.restore(str(tmp_path), 3, tree.tree_map(
            torch.zeros_like, params))
        for (k, a), b in zip(_port_paths(params).items(), tree.leaves(out)):
            assert torch.equal(a, b), k
    back = params_to_numpy(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    for (k, a), b in zip(_paths(jparams).items(), tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b), k


def _loss_and_grads(tspec, params, batch):
    params = tree.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                           params)
    loss, _ = build_model(tspec).loss(params, batch)
    loss.backward()
    return loss.detach(), [p.grad for p in tree.leaves(params)]


def test_remat_bit_for_bit_and_matches_reference():
    jspec, tspec = _specs("smollm-360m", remat=True)
    jparams, params = _ref_params(jspec, 50)
    rng = np.random.default_rng(51)
    toks = rng.integers(0, jspec.vocab_size, (2, 97)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    # One thread: on the CPU a product's bits depend on how many threads
    # split it, which a loaded host may change between two calls.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss_r, grads_r = _loss_and_grads(tspec, params, tbatch)
        loss_0, grads_0 = _loss_and_grads(
            dataclasses.replace(tspec, remat=False), params, tbatch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(loss_r, loss_0)
    for a, b in zip(grads_r, grads_0):
        assert torch.equal(a, b)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jbuild_model(jspec).loss, has_aux=True))(jparams, batch)
    np.testing.assert_allclose(float(loss_r), float(jl), rtol=1e-5)
    for a, g in zip(grads_r, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), **TOL)


def test_seq_parallel_still_raises():
    """Nothing raises any more: a ``seq_parallel`` spec builds, and
    without a sequence group (one rank, or serving) its loss and
    gradients are the plain spec's, bit for bit (the reference's
    constraint does nothing without a model axis either).  The sequence
    split itself: ``test_torch_seq_parallel.py``."""
    jspec, tspec = _specs("smollm-360m", seq_parallel=True)
    assert build_model(tspec).seq_parallel
    _, params = _ref_params(jspec, 52)
    rng = np.random.default_rng(53)
    toks = rng.integers(0, jspec.vocab_size, (2, 33)).astype(np.int64)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]),
              "labels": torch.from_numpy(toks[:, 1:])}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss_s, grads_s = _loss_and_grads(tspec, params, tbatch)
        loss_0, grads_0 = _loss_and_grads(
            dataclasses.replace(tspec, seq_parallel=False), params, tbatch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(loss_s, loss_0)
    for a, b in zip(grads_s, grads_0):
        assert torch.equal(a, b)
