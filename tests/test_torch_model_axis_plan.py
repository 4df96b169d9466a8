"""The model axis on the host: specs, the IR's model bracket and the
sharded norm against ``repro``, call for call.

* ``param_pspecs`` and ``divisibility_check`` of the four dense configs
  at full size (meta tensors / ``jax.eval_shape``), and
  ``model_shard_specs`` (with its per-leaf fallback to replicated),
  ``shard_param_structs`` and ``sharded_mask`` at m = 2 and 4, equal
  the reference's;
* ``bracket_chunk_bytes`` and the bracketed ``decompose`` (a ``shard``
  opener, the dp stages on the chunk, ``all_gather@model``) equal the
  reference's, float for float, and a bracket with a codec is its
  ``ValueError``;
* ``plan`` over the reduced smollm-360m tree, shard-shaped, on dp axes
  (2, 2) + m = 2, (4,) + m = 2 (data × model) and the flat fold over
  three dp axes (2, 2, 2), fixed and ``auto``, coded (the bracket
  skipped) and not: the reference's JSON, fingerprints and ``render``
  (``ring@data×rhd@pod×ag@model``);
* ``from_json`` of the reference's grouped and model-bracket records
  gives its JSON back;
* what still raises: a composed name on three dp axes; overlap on a
  model axis now arms on the shards;
* ``global_norm`` with neither argument equals the reference's bit for
  bit, and with ``sharded``/``model_group`` over a model axis of one
  rank the reference's under ``shard_map`` within 1e-6 relative (its
  compiled reductions round in another order).

Host arithmetic only: no ranks.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_spec as jget_spec
from repro.core import manual as jmanual
from repro.core import schedule as jschedule
from repro.core import selector as JS
from repro.core.compat import shard_map
from repro.models import build_model as jbuild_model
from repro.models import divisibility_check as jdivisibility_check
from repro.models import param_groups as jparam_groups
from repro.models import param_pspecs as jparam_pspecs
from repro.optim import clip as jclip

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import manual, schedule
from repro_torch.core import selector as S
from repro_torch.models import (divisibility_check, param_groups,
                                param_pspecs)
from repro_torch.models import transformer
from repro_torch.optim import clip

DENSE = ("smollm-360m", "granite-3-2b", "deepseek-7b", "gemma-7b")
THRESHOLD = 1 << 18
# (dp axis names, dp sizes, model axis size)
MESHES = ((("pod", "data"), (2, 2), 2), (("data",), (4,), 2),
          (("pod", "data", "x"), (2, 2, 2), 1),
          (("pod", "data", "x"), (2, 2, 2), 2))


def _jspec(spec):
    return tuple(spec)


def _fake_mesh(m):
    """What ``repro.core.manual.model_shard_specs`` reads of a mesh."""
    return types.SimpleNamespace(shape={"model": m},
                                 axis_names=("data", "model"))


@pytest.fixture(scope="module")
def full_trees():
    """Each dense config at full size: the reference's structs and the
    port's meta tensors."""
    out = {}
    for name in DENSE:
        jstruct = jax.eval_shape(jbuild_model(jget_spec(name)).init,
                                 jax.random.PRNGKey(0))
        tparams = transformer.init_params(torch.Generator().manual_seed(0),
                                          get_spec(name), "meta")
        out[name] = (jstruct, tparams)
    return out


@pytest.mark.parametrize("name", DENSE)
def test_param_pspecs_and_divisibility_match_reference(full_trees, name):
    jstruct, tparams = full_trees[name]
    want = [_jspec(s) for s in jax.tree_util.tree_leaves(
        jparam_pspecs(jstruct), is_leaf=lambda x: isinstance(x, P))]
    assert tree.leaves(param_pspecs(tparams)) == want
    assert tree.leaves(param_groups(tparams)) == want
    for m in (2, 3, 4, 16, 7):
        assert divisibility_check(tparams, m) == \
            jdivisibility_check(jstruct, m), m


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", DENSE)
def test_model_shard_specs_match_reference(full_trees, name, m):
    jstruct, tparams = full_trees[name]
    jspecs = jmanual.model_shard_specs(jstruct, _fake_mesh(m))
    got = manual.model_shard_specs(tparams, m)
    flat_j = jax.tree_util.tree_leaves(jspecs,
                                       is_leaf=lambda x: isinstance(x, P))
    assert tree.leaves(got) == [_jspec(s) for s in flat_j]
    jstructs = jmanual.shard_param_structs(jstruct, jspecs, m)
    got_structs = manual.shard_param_structs(tparams, got, m)
    assert [tuple(s.shape) for s in tree.leaves(got_structs)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(jstructs)]
    assert all(s.device.type == "meta" for s in tree.leaves(got_structs))
    assert tree.leaves(manual.sharded_mask(tparams, got)) == \
        jax.tree_util.tree_leaves(jmanual.sharded_mask(jstruct, jspecs))
    # the per-leaf fallback: at m = 7 no leaf divides, all replicated
    assert all(s == () for s in
               tree.leaves(manual.model_shard_specs(tparams, 7)))


def test_sharded_dim_and_chunk_bytes_match_reference():
    for spec in [(), (None, "model"), ("model", None),
                 (None, None, "model"), (None, ("data", "model"))]:
        assert manual.sharded_dim(spec) == jmanual.sharded_dim(P(*spec))
    for n in (0, 1, 4, 7, 1000, 12345, 4 << 20):
        for m in (1, 2, 3, 4, 16):
            for item in (2, 4):
                assert schedule.bracket_chunk_bytes(n, m, item) == \
                    jschedule.bracket_chunk_bytes(n, m, item)


def _stage_dump(stages):
    return json.dumps([st.to_json() for st in stages])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("strategy", ["rhd_rsa", "ring_rsa", "psum",
                                      "ps_gather", "ring_rsa×rhd_rsa",
                                      "hierarchical"])
def test_bracketed_decompose_matches_reference(mesh, strategy):
    names, sizes, m = mesh
    composed = "×" in strategy or (strategy == "hierarchical"
                                   and len(names) > 1)
    for n in (4, 1000, 12345 * 4, 4 << 20):
        kw = dict(model_axis="model", model_axis_size=m)
        if composed and len(names) != 2:
            with pytest.raises(ValueError):
                schedule.decompose(strategy, n, names, sizes, **kw)
            with pytest.raises(ValueError):
                jschedule.decompose(strategy, n, names, sizes, **kw)
            continue
        got = schedule.decompose(strategy, n, names, sizes, fused=True, **kw)
        ref = jschedule.decompose(strategy, n, names, sizes, fused=True,
                                  **kw)
        assert _stage_dump(got) == _stage_dump(ref)
        if m > 1:
            assert got[0].op == "shard" and got[-1].op == "all_gather"
            assert got[-1].axis == "model" and got[0].wire_bytes == 0
    if m > 1 and not (composed and len(names) != 2):
        with pytest.raises(ValueError, match="wire codecs"):
            schedule.decompose(strategy, 4096, names, sizes, codec="int8",
                               model_axis="model", model_axis_size=m)


@pytest.fixture(scope="module")
def reduced():
    """The reduced smollm-360m tree (reference structs, port meta
    tensors) and its specs."""
    spec = jget_spec("smollm-360m").reduced()
    jstruct = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    tstruct = tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        jstruct)
    return jstruct, tstruct


def _plans(reduced, mesh, strategy, codec):
    """The reference's and the port's plan of the shard-shaped reduced
    tree on ``mesh``."""
    names, sizes, m = mesh
    jstruct, tstruct = reduced
    jspecs = jmanual.model_shard_specs(jstruct, _fake_mesh(m))
    tspecs = manual.model_shard_specs(tstruct, m)
    jshards = jmanual.shard_param_structs(jstruct, jspecs, m)
    tshards = manual.shard_param_structs(tstruct, tspecs, m)
    kw = dict(axis_names=names, axis_sizes=sizes,
              threshold_bytes=THRESHOLD, codec=codec,
              model_axis="model", model_axis_size=m)
    if strategy == "auto":
        ref = jschedule.plan(jshards, groups=jparam_groups(jshards),
                             selector=JS.AnalyticSelector(codec=codec),
                             **kw)
        got = schedule.plan(tshards, groups=param_groups(tshards),
                            selector=S.AnalyticSelector(codec=codec), **kw)
    else:
        ref = jschedule.plan(jshards, groups=jparam_groups(jshards),
                             strategy=strategy, **kw)
        got = schedule.plan(tshards, groups=param_groups(tshards),
                            strategy=strategy, **kw)
    return ref, got


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("mesh,strategy", [
    (mesh, s) for mesh in MESHES
    for s in ("rhd_rsa", "psum")
    + (("auto",) if len(mesh[0]) < 3 else ())
    + (("ring_rsa×rhd_rsa",) if len(mesh[0]) == 2 else ())])
def test_bracketed_plan_matches_reference(reduced, mesh, strategy, codec):
    names, _, m = mesh
    ref, got = _plans(reduced, mesh, strategy, codec)
    assert json.dumps(got.to_json()) == json.dumps(ref.to_json())
    assert got.fingerprint() == ref.fingerprint()
    assert got.fingerprint(detached=True) == ref.fingerprint(detached=True)
    assert got.render() == ref.render()
    bracket = m > 1 and codec == "none"
    assert got.bracketed == bracket
    assert ("ag@model" in got.render()) == bracket
    if bracket and strategy == "ring_rsa×rhd_rsa":
        assert "ring@data×rhd@pod×ag@model" in got.render()
    for rec in (got.to_json(), ref.to_json(), ref.to_json(group=True)):
        assert json.dumps(schedule.from_json(rec).to_json()) == \
            json.dumps(jschedule.from_json(rec).to_json())
        assert schedule.from_json(rec).fingerprint(detached=True) == \
            ref.fingerprint(detached=True)


def test_what_still_raises(reduced):
    """A composed name and ``auto`` on three dp axes (the reference's
    ValueErrors); overlap on a model axis arms, and the rest
    validates."""
    jstruct, tstruct = reduced
    for mod in (schedule, jschedule):
        with pytest.raises(ValueError, match="needs a 2-axis mesh"):
            mod.decompose("ring_rsa×rhd_rsa", 1024, ("pod", "data", "x"),
                          (2, 2, 2))
    for mod, sel, struct in ((schedule, S, tstruct),
                             (jschedule, JS, jstruct)):
        with pytest.raises(ValueError, match="1- or 2-axis"):
            mod.plan(struct, axis_names=("pod", "data", "x"),
                     axis_sizes=(2, 2, 2),
                     selector=sel.AnalyticSelector(), model_axis="model",
                     model_axis_size=2)
    sched = schedule.plan(tstruct, axis_names=("pod", "data", "x"),
                          axis_sizes=(2, 2, 2), strategy="rhd_rsa",
                          model_axis="model", model_axis_size=2)
    bracketed = [b for b in sched.buckets if b.stages[0].op == "shard"]
    assert bracketed and all(b.render() == "rhd@x×rhd@data×rhd@pod×ag@model"
                             for b in bracketed)
    groups = {ax: Group(name=ax) for ax in ("pod", "data", "model")}
    agg = GradientAggregator(AggregatorConfig(overlap=True),
                             ("pod", "data"), groups, model_axis="model")
    # Overlap on a model axis arms on the shards (one rank here: the
    # plan of axes of size 1, nothing bracketed).
    run = agg.overlap_params(tree.tree_map(
        lambda s: torch.zeros(s.shape, requires_grad=True), tstruct))
    assert run.sched.model_axis is None and agg.last_schedule is run.sched
    agg._run = None
    with pytest.raises(ValueError, match="needs its size"):
        agg.resolve(tstruct, (2, 2))
    sched = agg.resolve(tstruct, (2, 2), model_axis_size=2)
    assert sched.model_axis == "model" and sched.model_axis_size == 2


def test_sharded_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                    "d": rng.standard_normal((3, 5)).astype(np.float32)}}
    mask = {"a": True, "b": {"c": False, "d": True}}
    tarrays = tree.tree_map(torch.from_numpy, arrays)
    plain = clip.global_norm(tarrays)
    assert plain.numpy() == np.asarray(jclip.global_norm(arrays))
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    want = shard_map(lambda t: jclip.global_norm(t, sharded=mask,
                                                 model_axis="model"),
                     mesh, in_specs=(P(),), out_specs=P(),
                     check_vma=False)(arrays)
    got = clip.global_norm(tarrays, sharded=mask,
                           model_group=Group(name="model"))
    # The reference's reductions compiled under shard_map round in
    # another order than eager ones: one ulp apart here.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    clipped, norm = clip.clip_by_global_norm(tarrays, 0.5, sharded=mask,
                                             model_group=Group(name="model"))
    jclipped, jnorm = shard_map(
        lambda t: jclip.clip_by_global_norm(t, 0.5, sharded=mask,
                                            model_axis="model"),
        mesh, in_specs=(P(),), out_specs=P(), check_vma=False)(arrays)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=1e-6)
    for a, b in zip(tree.leaves(clipped), jax.tree_util.tree_leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
