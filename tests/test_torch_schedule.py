"""The port's planner against the reference's: ``plan()`` over the
reduced smollm-360m gradient shapes must give a byte-identical
``repro/schedule/v1`` JSON and the same fingerprint, for every fixed
strategy × codec × data-axis size; the closed-form ``wire_bytes`` /
``allreduce_steps`` tables and the parameter group tags must match."""
import json

import jax
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.core import reducers as jreducers
from repro.core import schedule as jschedule
from repro.models import build_model as jbuild_model
from repro.models import param_groups as jparam_groups

from repro_torch import tree
from repro_torch.configs import get_spec
from repro_torch.core import reducers, schedule
from repro_torch.core.aggregator import AggregatorConfig
from repro_torch.models import param_groups
from repro_torch.models.transformer import init_params

STRATEGIES = ("psum", "ring_rsa", "rhd_rsa", "ps_gather")
CODECS = ("none", "bf16", "int8", "fp8_e4m3")
THRESHOLD = int(0.25 * 2 ** 20)


@pytest.fixture(scope="module")
def shapes():
    spec = jget_spec("smollm-360m").reduced()
    jstruct = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    tstruct = tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32), jstruct)
    return jstruct, tstruct


def _dump(sched) -> str:
    return json.dumps(sched.to_json())


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plan_json_and_fingerprint_match_reference(shapes, strategy, codec,
                                                   p):
    jstruct, tstruct = shapes
    kw = dict(axis_names=("data",), axis_sizes=(p,), strategy=strategy,
              threshold_bytes=THRESHOLD, codec=codec)
    ref = jschedule.plan(jstruct, groups=jparam_groups(jstruct), **kw)
    got = schedule.plan(tstruct, groups=param_groups(tstruct), **kw)
    assert _dump(got) == _dump(ref)
    assert got.fingerprint() == ref.fingerprint()
    assert got.fingerprint(detached=True) == ref.fingerprint(detached=True)
    back = schedule.from_json(got.to_json())
    assert back.fingerprint() == got.fingerprint()
    assert _dump(schedule.with_fused_hops(got, fused=True)) == \
        _dump(jschedule.with_fused_hops(ref, fused=True))


@pytest.mark.parametrize("fuse,threshold,ef,fused_hops", [
    (False, 4 << 20, False, None),
    (True, 4 << 20, True, None),
    (True, 1 << 16, False, True),
    (True, 1 << 16, False, False),
])
def test_plan_options_match_reference(shapes, fuse, threshold, ef,
                                      fused_hops):
    jstruct, tstruct = shapes
    kw = dict(axis_names=("data",), axis_sizes=(4,), strategy="rhd_rsa",
              threshold_bytes=threshold, fuse=fuse, codec="int8",
              error_feedback=ef, fused_hops=fused_hops)
    ref = jschedule.plan(jstruct, groups=jparam_groups(jstruct), **kw)
    got = schedule.plan(tstruct, groups=param_groups(tstruct), **kw)
    assert _dump(got) == _dump(ref)


def test_gdr_opt_config_buckets(shapes):
    """The slice's configuration (rhd_rsa + int8, fused hops by default)
    on the reduced model: 9 buckets, every one a fused int8 RHD
    allreduce, as the reference plans it."""
    _, tstruct = shapes
    cfg = AggregatorConfig(strategy="rhd_rsa", codec="int8",
                           fusion_threshold_mb=0.25)
    sched = schedule.plan(tstruct, axis_names=("data",), axis_sizes=(2,),
                          strategy=cfg.strategy,
                          threshold_bytes=cfg.threshold_bytes,
                          groups=param_groups(tstruct), codec=cfg.codec,
                          fused_hops=cfg.fused_hops)
    assert sched.n_buckets == 9
    assert {(st.op, st.algorithm, st.codec, st.fused_hop)
            for b in sched.buckets for st in b.stages} == \
        {("allreduce", "rhd_rsa", "int8", True)}


def test_param_groups_match_reference(shapes):
    jstruct, tstruct = shapes
    assert tree.leaves(param_groups(tstruct)) == jax.tree_util.tree_leaves(
        jparam_groups(jstruct), is_leaf=lambda x: isinstance(x, tuple))


def test_port_init_has_the_reference_tree(shapes):
    jstruct, _ = shapes
    params = init_params(torch.Generator().manual_seed(0),
                         get_spec("smollm-360m").reduced(), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jstruct)[0]
    got = tree.leaves_with_path(params)
    assert [tuple(k.key for k in path) for path, _ in jflat] == \
        [path for path, _ in got]
    assert [tuple(s.shape) for _, s in jflat] == \
        [tuple(t.shape) for _, t in got]
    assert all(t.dtype == torch.float32 for _, t in got)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wire_bytes_and_steps_tables_match_reference(strategy):
    for p in range(1, 17):
        for n in (0, 1, 1000, 4096, 12345678):
            assert reducers.wire_bytes(strategy, n, p) == \
                jreducers.wire_bytes(strategy, n, p)
        if strategy != "psum":
            assert reducers.allreduce_steps(strategy, p) == \
                jreducers.allreduce_steps(strategy, p)


def test_unported_plans_raise(shapes):
    """What still raises: a wire codec inside the model bracket and a
    composed name on three dp axes or on one (the reference's
    ``ValueError``) and ``auto`` as a fixed name.  Overlap on a model
    axis arms on the shards; the model bracket, three dp axes, composed
    and two-axis schedules, ``AggregatorConfig`` with a composed name,
    ``auto`` and ``overlap`` validate."""
    from repro_torch.core import Group, GradientAggregator, selector
    _, tstruct = shapes
    with pytest.raises(ValueError, match="wire codecs"):
        schedule.decompose("rhd_rsa", 1024, ("pod", "data"), (2, 2),
                           codec="int8", model_axis="model",
                           model_axis_size=2)
    with pytest.raises(ValueError, match="needs a 2-axis mesh"):
        schedule.plan(tstruct, axis_names=("pod", "data", "x"),
                      axis_sizes=(2, 2, 2), strategy="ring_rsa×rhd_rsa")
    with pytest.raises(ValueError, match="needs a 2-axis mesh"):
        schedule.plan(tstruct, axis_names=("data",), axis_sizes=(2,),
                      strategy="ring_rsa×rhd_rsa")
    with pytest.raises(ValueError, match="unknown strategy"):
        schedule.plan(tstruct, axis_names=("data",), axis_sizes=(2,),
                      strategy="auto")
    groups = {"data": Group(name="data"), "model": Group(name="model")}
    agg = GradientAggregator(AggregatorConfig(overlap=True), ("data",),
                             groups, model_axis="model")
    run = agg.overlap_params(tree.tree_map(
        lambda t: torch.zeros(t.shape, requires_grad=True), tstruct))
    assert agg._run is run and run.sched is agg.last_schedule
    agg._run = None
    sched = schedule.plan(tstruct, axis_names=("pod", "data"),
                          axis_sizes=(2, 2), model_axis="model",
                          model_axis_size=2)
    assert sched.bracketed and "ag@model" in sched.render()
    sched = schedule.plan(tstruct, axis_names=("pod", "data", "x"),
                          axis_sizes=(2, 2, 2))
    assert {len(b.stages) for b in sched.buckets} == {3}
    assert schedule.plan(tstruct, axis_names=("pod", "data"),
                         axis_sizes=(2, 2), codec="int8",
                         model_axis="model",
                         model_axis_size=2).model_axis is None
    for sel in (None, selector.AnalyticSelector()):
        sched = schedule.plan(tstruct, axis_names=("pod", "data"),
                              axis_sizes=(2, 2), selector=sel,
                              strategy="ring_rsa×rhd_rsa")
        assert sched.n_buckets >= 1
    AggregatorConfig(strategy="ring_rsa×rhd_rsa").validate()
    AggregatorConfig(strategy="auto").validate()
    AggregatorConfig(overlap=True).validate()
