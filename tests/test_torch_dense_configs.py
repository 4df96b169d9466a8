"""The port's other dense configs against the reference's, on the CPU.

For smollm-360m, granite-3-2b, deepseek-7b and gemma-7b:

* the port's spec equals the reference's field by field, full and
  reduced;
* at ``reduced()`` size in float32, from the reference's own initial
  weights carried over by ``convert.params_from_numpy``, the loss and
  every gradient leaf agree with ``repro.models`` at rtol 1e-4 / atol
  1e-5 (``tests/test_torch_model.py``'s tolerance: the two frameworks
  sum in different orders).  gemma-7b's reduced spec exercises GeGLU,
  ``scale_embed`` with tied embeddings and a head_dim set apart from
  ``d_model / num_heads``;
* gemma-7b reduced but with ``head_dim`` kept at 256, at seq 96 (above
  the reduced ``attn_full_seq_max`` of 64): both models take their flash
  path at head_dim 256 (the port's chunked plain K7/K8 on the CPU).

Then the aggregate at gemma-7b's full size, on meta tensors (shapes
only): its tied embedding is one 786,432,000-element leaf, fused into a
bucket of its own whose sizes stay Python integers; and the loss, whose
backward keeps the logits as given and equals autograd's composite.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import build_model as jbuild_model

from repro_torch import tree
from repro_torch.configs import get_spec, list_archs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import AggregatorConfig, GradientAggregator, reducers
from repro_torch.core import dist as dist_mod
from repro_torch.models import build_model, param_groups, transformer
from repro_torch.models.common import cross_entropy

ARCHS = ["smollm-360m", "granite-3-2b", "deepseek-7b", "gemma-7b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _fields(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_reference(arch):
    assert arch in list_archs()
    for j, t in ((jget_spec(arch), get_spec(arch)),
                 (jget_spec(arch).reduced(), get_spec(arch).reduced())):
        assert _fields(t) == _fields(j)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.padded_vocab == j.padded_vocab


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _check_against_reference(jspec, tspec, b, s, seed):
    """Loss and every gradient leaf of the port against the reference,
    from the reference's initial weights."""
    model = jbuild_model(jspec)
    jparams = model.init(jax.random.PRNGKey(seed))
    batch = _batch(jspec.vocab_size, b, s, seed)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(model.loss,
                                                    has_aux=True))(
        jparams, batch)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(np_params, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    loss, _ = build_model(tspec).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    got = tree.leaves_with_path(params)
    want = tree.leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        assert p.grad.shape == g.shape, "/".join(path)
        np.testing.assert_allclose(p.grad.numpy(), g, err_msg="/".join(path),
                                   **TOL)
    return np_params, params


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_grads_match_reference(arch):
    jspec = dataclasses.replace(jget_spec(arch).reduced(), dtype="float32")
    tspec = dataclasses.replace(get_spec(arch).reduced(), dtype="float32")
    np_params, params = _check_against_reference(jspec, tspec, 2, 32,
                                                 seed=ARCHS.index(arch))
    # convert.py: the same tree back, bit for bit; tied specs carry no
    # lm_head, and every body leaf is stacked over the layers.
    back = params_to_numpy(params)
    for a, b in zip(tree.leaves(back), tree.leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ("lm_head" in params) != tspec.tie_embeddings
    assert all(p.shape[0] == tspec.num_layers
               for p in tree.leaves(params["body"]))


def test_gemma_head_dim_256_flash_path_matches_reference():
    """head_dim 256 at seq 96 > attn_full_seq_max (64): the reference's
    chunked flash path against the port's K7/K8 plain versions."""
    jspec = dataclasses.replace(jget_spec("gemma-7b").reduced(),
                                head_dim=256, dtype="float32")
    tspec = dataclasses.replace(get_spec("gemma-7b").reduced(),
                                head_dim=256, dtype="float32")
    assert 96 > tspec.attn_full_seq_max and tspec.resolved_head_dim == 256
    _, params = _check_against_reference(jspec, tspec, 1, 96, seed=7)
    assert tuple(params["body"]["attn"]["wq"].shape) == (2, 256, 4 * 256)


def _composite_cross_entropy(logits, labels, mask=None):
    """The loss as ``logsumexp`` and ``gather`` under autograd."""
    x = logits.to(torch.float32)
    nll = torch.logsumexp(x, dim=-1) - torch.gather(
        x, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_autograd_and_keeps_logits_as_given(dtype,
                                                                  masked):
    """The loss and its gradient equal the autograd composite's bit for
    bit; the backward keeps the logits in their own dtype (bf16 at half
    the bytes of an f32 copy), which at gemma-7b's vocabulary and 4096
    tokens is 2.1 GB where the copy was 4.2."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 19, 1000, generator=gen) * 4).to(dtype)
    labels = torch.randint(0, 1000, (2, 19), generator=gen,
                           dtype=torch.int32)
    mask = torch.rand(2, 19, generator=gen) > 0.3 if masked else None
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        loss = cross_entropy(a, labels, mask)
    loss.backward()
    want = _composite_cross_entropy(b, labels, mask)
    want.backward()
    assert torch.equal(loss, want)
    assert a.grad.dtype == dtype and torch.equal(
        a.grad.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
        b.grad.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    big = [t for t in saved if t.numel() == x.numel()]
    assert len(big) == 1 and big[0].dtype == dtype


def test_gemma_attention_widths_are_set_apart_from_d_model():
    """gemma-7b's head_dim (256) is not d_model / num_heads (192): wq is
    3072 x 4096 and wo 4096 x 3072 at full width."""
    spec = get_spec("gemma-7b")
    assert spec.d_model // spec.num_heads == 192
    params = transformer.init_params(torch.Generator().manual_seed(0),
                                     dataclasses.replace(spec, num_layers=1),
                                     "meta")
    attn = params["body"]["attn"]
    assert tuple(attn["wq"].shape) == (1, 3072, 4096)
    assert tuple(attn["wk"].shape) == tuple(attn["wv"].shape) == \
        (1, 3072, 4096)
    assert tuple(attn["wo"].shape) == (1, 4096, 3072)
    assert tuple(params["embed"].shape) == (256000, 3072)
    assert "lm_head" not in params


def test_gemma_full_size_aggregate_plan():
    """All 28 layers on meta tensors: 8,537,680,896 parameters; the tied
    embedding (786,432,000 elements, 3.1 GB in f32) is a bucket of its
    own, passed on without a copy, and its sizes, hop lengths and wire
    bytes stay Python integers."""
    spec = get_spec("gemma-7b")
    params = transformer.init_params(torch.Generator().manual_seed(0), spec,
                                     "meta")
    assert sum(p.numel() for p in tree.leaves(params)) == 8_537_680_896
    agg = GradientAggregator(AggregatorConfig(strategy="rhd_rsa",
                                              codec="int8"),
                             ("data",), {"data": dist_mod.Group()})
    sched = agg.resolve(params, (2,), groups=param_groups(params))
    plan = sched.plan
    embed_index = [path for path, _ in tree.leaves_with_path(params)].index(
        ("embed",))
    (bucket,) = [b for b in plan.buckets if embed_index in b.leaf_indices]
    assert bucket.leaf_indices == (embed_index,)
    assert bucket.size == 786_432_000 and isinstance(bucket.size, int)
    leaves = tree.leaves(params)
    assert plan.flatten_bucket(bucket, [leaves[embed_index]]) \
        is leaves[embed_index]
    # The first RHD hop at p = 2 carries half the rows: 393,216,000 f32
    # values, 393,216,000 int8 bytes on the wire.
    assert bucket.size // 2 == 393_216_000
    assert reducers.wire_bytes("rhd_rsa", 4 * bucket.size, 2) == \
        4 * bucket.size
    assert max(b.size for b in plan.buckets) < 2 ** 31 <= \
        sum(b.size for b in plan.buckets)


def test_build_trainer_takes_a_spec():
    """``build_trainer(..., spec=...)`` trains the spec given (here a
    one-layer gemma-7b at head_dim 256 above ``attn_full_seq_max``) in
    place of ``--arch``; the launcher's flags are unchanged."""
    from repro_torch.launch.train import build_trainer, parser
    args = parser().parse_args(["--arch", "gemma-7b", "--steps", "1",
                                "--batch", "2", "--seq", "96",
                                "--device", "cpu"])
    spec = dataclasses.replace(get_spec("gemma-7b").reduced(), num_layers=1,
                               head_dim=256, dtype="float32")
    trainer = build_trainer(args, verbose=False, spec=spec)
    assert trainer.model.spec is spec
    module, state = trainer.init_state(0)
    assert tuple(module.tree()["body"]["attn"]["wq"].shape) == (1, 256, 1024)
    _, _, history = trainer.run(1, module, state)
    assert np.isfinite(history[0]["loss"])
    assert not any(a.dest == "spec" for a in parser()._actions)
