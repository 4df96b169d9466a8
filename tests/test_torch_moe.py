"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py`` on the CPU, in float32, from the
reference's own initial weights and numpy inputs (~6 s, one process).

Cases: a capacity that drops tokens (``drop`` equal exactly), several
token groups (``moe_group_size`` 16), shared experts (deepseek-v2-lite's
reduced spec), an ample capacity; the routing (``top_i``) equal to
``lax.top_k`` of the reference's probabilities, also on rows built with
exact ties, where the lower expert index wins; gradients of
``sum(y·w) + aux`` against ``jax.grad``; the reference's permutation
test, mirrored; and two calls giving the same bits (the combine has no
scatter-add).  ``y`` and its gradients are held at rtol 1e-5 (1e-4 for
the gradients) with an atol of 1e-6 of the tensor's largest magnitude:
the experts' LeCun init over the expert dim (the reference's) makes
``y`` of order 1e3, where f32 sums in another order differ by ~1e-4.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.models import moe as jmoe

from repro_torch.configs import get_spec
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe

# label -> (arch, ModelSpec overrides, tokens (B, S))
CASES = {
    "drop": ("granite-moe-1b-a400m", {"capacity_factor": 1.0}, (2, 24)),
    "groups": ("granite-moe-1b-a400m", {"moe_group_size": 16,
                                        "capacity_factor": 1.25}, (2, 40)),
    "shared": ("deepseek-v2-lite-16b", {}, (2, 24)),
    "ample": ("granite-moe-1b-a400m", {"capacity_factor": 8.0}, (3, 16)),
}


def _specs(arch, over):
    j = dataclasses.replace(jget_spec(arch).reduced(), dtype="float32",
                            **over)
    t = dataclasses.replace(get_spec(arch).reduced(), dtype="float32",
                            **over)
    return j, t


def _inputs(spec, shape, seed, ties=False):
    jparams = jmoe.moe_params(jax.random.PRNGKey(seed), spec)
    if ties:
        # experts 1 and 3 share a router column: every token's two
        # probabilities tie exactly.
        r = np.asarray(jparams["router"]).copy()
        r[:, 3] = r[:, 1]
        jparams = {**jparams, "router": jnp.asarray(r)}
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    x = np.random.default_rng(seed).standard_normal(
        shape + (spec.d_model,)).astype(np.float32)
    return jparams, np_params, x


def _ref_top_i(jparams, x, spec):
    xt = jnp.asarray(x).reshape(-1, spec.d_model)
    probs = jax.nn.softmax((xt @ jparams["router"]).astype(jnp.float32), -1)
    return np.asarray(jax.lax.top_k(probs, spec.top_k)[1])


def _close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _check_case(arch, over, shape, seed, ties=False):
    jspec, tspec = _specs(arch, over)
    jparams, np_params, x = _inputs(jspec, shape, seed, ties)
    # eager, as op by op the reference's drop is 1 - n/(t·k) exactly as
    # the port computes it (under jit XLA rounds the quotient otherwise)
    jy, jaux, jdrop = jmoe.moe_forward(jparams, jnp.asarray(x), jspec)
    routes, top_k = [], moe.top_k

    def recording(probs, k):
        w, i = top_k(probs, k)
        routes.append(i.reshape(-1, k))
        return w, i

    with mock.patch.object(moe, "top_k", recording):
        y, aux, drop = moe.moe_forward(params_from_numpy(np_params),
                                       torch.from_numpy(x), tspec)
    _close(y.numpy(), np.asarray(jy), 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(drop) == float(jdrop)
    top_i = _ref_top_i(jparams, x, jspec)
    assert np.array_equal(routes[0].numpy(), top_i)
    return float(jdrop), top_i


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_reference(case):
    arch, over, shape = CASES[case]
    drop, _ = _check_case(arch, over, shape, seed=list(CASES).index(case))
    if case in ("drop", "groups"):
        assert drop > 0.0                 # the capacity did drop tokens
    if case == "ample":
        assert drop == 0.0


def test_group_count_is_the_references():
    """``t // moe_group_size`` lowered until it divides ``t``."""
    spec = dataclasses.replace(get_spec("granite-moe-1b-a400m").reduced(),
                               moe_group_size=16)
    assert [moe._groups(t, spec) for t in (8, 16, 40, 48, 50, 4096)] == \
        [1, 1, 2, 3, 2, 256]
    assert moe._capacity(40, spec) == jmoe._capacity(40, jget_spec(
        "granite-moe-1b-a400m").reduced())


def test_exact_ties_pick_the_lower_expert_index():
    """Router columns 1 and 3 equal: every token ties them exactly, and
    the routing still equals ``lax.top_k``'s (lower index first)."""
    _, top_i = _check_case("granite-moe-1b-a400m", {"capacity_factor": 8.0},
                           (2, 24), seed=5, ties=True)
    both = (top_i == 1).any(-1) & (top_i == 3).any(-1)
    only_one = (top_i == 1).any(-1) ^ (top_i == 3).any(-1)
    assert not (top_i == 3)[only_one].any()     # 1 beats its twin 3
    assert both.any() or only_one.any()
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15],
                          [0.1, 0.3, 0.3, 0.0, 0.3]])
    w, i = moe.top_k(probs, 3)
    jw, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert i.tolist() == [[0, 1, 3], [1, 2, 4]]
    assert np.array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("case", ["drop", "shared"])
def test_moe_gradients_match_reference(case):
    """Gradients of ``sum(y·w) + aux`` with respect to every parameter
    and to ``x``."""
    arch, over, shape = CASES[case]
    jspec, tspec = _specs(arch, over)
    jparams, np_params, x = _inputs(jspec, shape, seed=11)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux, _ = jmoe.moe_forward(p, xx, jspec)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams,
                                                        jnp.asarray(x))
    params = params_from_numpy(np_params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = moe.moe_forward(params, xt, tspec)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    _close(xt.grad.numpy(), np.asarray(jgx), 1e-4)
    want = dict(jax.tree_util.tree_leaves_with_path(jgp))
    for path, p in leaves:
        _close(p.grad.numpy(), np.asarray(want[path]), 1e-4)


def test_moe_routing_invariants():
    """The reference's ``test_moe_routing_invariants``, on the port:
    ample capacity drops nothing, the aux loss is balanced-ish, and the
    output is equivariant to a permutation of the batch."""
    spec = dataclasses.replace(get_spec("granite-moe-1b-a400m").reduced(),
                               capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(gen, spec)
    x = torch.randn((2, 16, spec.d_model), generator=gen)
    y, aux, drop = moe.moe_forward(params, x, spec)
    assert y.shape == x.shape
    assert float(drop) == 0.0
    assert 0.5 < float(aux) < 4.0
    y2, _, _ = moe.moe_forward(params, x.flip(0), spec)
    np.testing.assert_allclose(y2.numpy(), y.flip(0).numpy(), atol=1e-5)


def test_moe_combine_gives_the_same_bits_twice():
    jspec, tspec = _specs("deepseek-v2-lite-16b", {"moe_group_size": 16})
    _, np_params, x = _inputs(jspec, (2, 48), seed=3)
    params = params_from_numpy(np_params)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tspec = dataclasses.replace(tspec, dtype="bfloat16")
    a = moe.moe_forward(params, xt, tspec)
    b = moe.moe_forward(params, xt, tspec)
    for u, v in zip(a, b):
        assert torch.equal(u.view(torch.int16) if u.dtype == torch.bfloat16
                           else u, v.view(torch.int16)
                           if v.dtype == torch.bfloat16 else v)
