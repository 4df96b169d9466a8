"""The port's plan cache and stage executors (``core/plan_cache.py``).

The cases of the reference's ``tests/test_plan_cache.py`` against
``repro_torch.core.plan_cache``: a hit on the same structure, a miss on
each of shape, dtype, threshold and group, ``clear``, the stats
snapshot, concurrent builds of one key building once and ``clear``
during a build.  Then the port's own: a cached ``plan`` returns the
identical schedule, with the reference's fingerprint on the reduced
smollm-360m tree, and misses on every change of its request; a
``StageExecutor`` called twice is built once and keeps its buffers; the
aggregator through the executor gives the bits of the uncached path
(``plan(cache=None)``, ``flatten``, ``execute_stages``).
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.core import schedule as jschedule
from repro.models import build_model as jbuild_model
from repro.models import param_groups as jparam_groups

from repro_torch import tree
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import plan_cache as pc_mod
from repro_torch.core import schedule
from repro_torch.core.plan_cache import (PlanCache, StageExecutor,
                                         StageExecutorCache)
from repro_torch.models import param_groups

from test_torch_transport import _uncached


def _tree(n=8, dtype=torch.float32):
    return {"a": torch.zeros((n,), dtype=dtype),
            "b": torch.zeros((n, 2), dtype=dtype)}


def test_hit_on_same_structure():
    cache = PlanCache()
    p1 = cache.get_or_build(_tree(), 1024)
    p2 = cache.get_or_build(_tree(), 1024)
    assert p1 is p2
    assert cache.stats.hits == 1 and cache.stats.misses == 1


def test_miss_on_shape_change():
    cache = PlanCache()
    cache.get_or_build(_tree(8), 1024)
    cache.get_or_build(_tree(9), 1024)
    assert cache.stats.misses == 2


def test_miss_on_dtype_threshold_group_change():
    cache = PlanCache()
    cache.get_or_build(_tree(), 1024)
    cache.get_or_build(_tree(dtype=torch.bfloat16), 1024)
    cache.get_or_build(_tree(), 2048)
    cache.get_or_build(_tree(), 1024, groups={"a": (), "b": ("model",)})
    assert cache.stats.misses == 4
    assert len(cache) == 4


def test_clear():
    cache = PlanCache()
    cache.get_or_build(_tree(), 1024)
    cache.clear()
    assert len(cache) == 0 and cache.stats.misses == 0


def test_stats_callable_snapshot():
    cache = PlanCache()
    cache.get_or_build(_tree(), 1024)
    cache.get_or_build(_tree(), 1024)
    snap = cache.stats()
    assert snap["hits"] == 1 and snap["misses"] == 1
    assert snap["hit_rate"] == 0.5
    assert snap["interned"] == 1
    assert snap["n_builds"] == 1
    assert list(snap["builds"].values()) == [1]
    assert cache.stats.hits == 1


def _slow_build(monkeypatch):
    started, release = threading.Event(), threading.Event()
    real = pc_mod.fusion.build_plan

    def slow(*args, **kwargs):
        started.set()
        release.wait(timeout=30)
        return real(*args, **kwargs)

    monkeypatch.setattr(pc_mod.fusion, "build_plan", slow)
    return started, release, real


def test_concurrent_same_key_builds_once(monkeypatch):
    cache = PlanCache()
    started, release, _ = _slow_build(monkeypatch)
    results = []

    def worker():
        results.append(cache.get_or_build(_tree(), 1024))

    t1 = threading.Thread(target=worker)
    t1.start()
    assert started.wait(timeout=30)
    t2 = threading.Thread(target=worker)    # misses while t1 builds
    t2.start()
    release.set()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not t1.is_alive() and not t2.is_alive()
    assert len(results) == 2 and results[0] is results[1]
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    assert len(cache) == 1


def test_clear_during_build_keeps_cache_empty(monkeypatch):
    cache = PlanCache()
    started, release, real = _slow_build(monkeypatch)
    t = threading.Thread(target=lambda: cache.get_or_build(_tree(), 1024))
    t.start()
    assert started.wait(timeout=30)
    cache.clear()
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(cache) == 0 and cache.stats.misses == 0
    monkeypatch.setattr(pc_mod.fusion, "build_plan", real)
    cache.get_or_build(_tree(), 1024)
    assert len(cache) == 1 and cache.stats.misses == 1


# ---------------------------------------------------------------------------
# The cached planner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes():
    spec = jget_spec("smollm-360m").reduced()
    jstruct = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    tstruct = tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32), jstruct)
    return jstruct, tstruct


PLAN_KW = dict(axis_names=("data",), axis_sizes=(4,), strategy="rhd_rsa",
               threshold_bytes=1 << 18, codec="int8")


def test_cached_plan_is_the_reference_plan(shapes):
    jstruct, tstruct = shapes
    cache = PlanCache()
    groups = param_groups(tstruct)
    first = schedule.plan(tstruct, groups=groups, cache=cache, **PLAN_KW)
    again = schedule.plan(tree.tree_map(torch.zeros_like, tstruct),
                          groups=param_groups(tstruct), cache=cache,
                          **PLAN_KW)
    assert again is first
    assert (cache.stats.misses, cache.stats.hits) == (1, 1)
    ref = jschedule.plan(jstruct, groups=jparam_groups(jstruct), **PLAN_KW)
    assert first.fingerprint() == ref.fingerprint()
    assert first.fingerprint() == schedule.plan(
        tstruct, groups=groups, **PLAN_KW).fingerprint()


def _variants(tstruct):
    """One change of each part of the request."""
    grown = dict(tstruct, embed=torch.empty(
        (tstruct["embed"].shape[0] + 1,) + tuple(tstruct["embed"].shape[1:])))
    half = tree.tree_map(lambda t: t.to(torch.bfloat16), tstruct)
    return {
        "shape": (grown, {}),
        "dtype": (half, {}),
        "groups": (tstruct, {"groups": None}),
        "threshold": (tstruct, {"threshold_bytes": 1 << 17}),
        "fuse": (tstruct, {"fuse": False}),
        "codec": (tstruct, {"codec": "fp8_e4m3"}),
        "strategy": (tstruct, {"strategy": "ring_rsa"}),
        "axis_sizes": (tstruct, {"axis_sizes": (8,)}),
    }


@pytest.mark.parametrize("change", ["shape", "dtype", "groups", "threshold",
                                    "fuse", "codec", "strategy",
                                    "axis_sizes"])
def test_cached_plan_misses_on_every_change(shapes, change):
    _, tstruct = shapes
    cache = PlanCache()
    base = schedule.plan(tstruct, groups=param_groups(tstruct), cache=cache,
                         **PLAN_KW)
    t, over = _variants(tstruct)[change]
    kw = {**PLAN_KW, "groups": param_groups(t), **over}
    other = schedule.plan(t, cache=cache, **kw)
    assert other is not base
    assert (cache.stats.misses, cache.stats.hits) == (2, 0)
    assert other.fingerprint() == schedule.plan(t, **kw).fingerprint()


# ---------------------------------------------------------------------------
# Stage executors and the aggregator
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((6, 5))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
            "c": torch.from_numpy(rng.standard_normal((40, 30))
                                  .astype(np.float32))}


def test_executor_builds_once_and_keeps_its_buffers():
    sched = schedule.plan(_grads(0), axis_names=("data",), axis_sizes=(1,),
                          threshold_bytes=1024, codec="int8")
    cache = StageExecutorCache()
    groups = {"data": Group()}
    ex = cache.executor_for(sched, groups, "cpu")
    assert isinstance(ex, StageExecutor) and ex.traces == 1
    owned = [b for b in ex.buffers if b is not None]
    assert owned and all(b.dtype == torch.float32 for b in owned)
    ptrs = [b.data_ptr() for b in owned]
    outs = [ex(_grads(s)) for s in (1, 2)]
    assert cache.executor_for(sched, groups, "cpu") is ex
    assert (ex.traces, ex.calls) == (1, 2)
    assert [b.data_ptr() for b in ex.buffers if b is not None] == ptrs
    assert cache.stats()["traces"] == 1 and len(cache) == 1
    for s, out in zip((1, 2), outs):
        assert torch.equal(out["c"], _grads(s)["c"])   # one rank: identity


def test_executor_refuses_a_detached_schedule():
    sched = schedule.plan(_grads(0), axis_names=("data",), axis_sizes=(1,))
    detached = schedule.from_json(sched.to_json())
    with pytest.raises(ValueError, match="attached"):
        StageExecutor(detached, {"data": Group()}, "cpu")


@pytest.mark.parametrize("cfg", [
    dict(codec="int8"), dict(strategy="ring_rsa"),
    dict(wire_dtype="bfloat16"), dict(codec="fp8_e4m3", fuse=False)])
def test_aggregator_through_executor_matches_uncached_path(cfg):
    cfg = AggregatorConfig(fusion_threshold_mb=1 / 1024, **cfg)
    groups = {"data": Group()}
    pc_mod.GLOBAL_EXECUTOR_CACHE.clear()
    agg = GradientAggregator(cfg, ("data",), groups, cache=PlanCache())
    for seed in (3, 4):
        grads = _grads(seed)
        got = agg(grads)
        want = _uncached(cfg, grads, groups, 1)
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert agg.cache.stats.misses == 1 and agg.cache.stats.hits == 1
    ex = pc_mod.GLOBAL_EXECUTOR_CACHE.executor_for(agg.last_schedule,
                                                   groups, "cpu")
    assert (ex.traces, ex.calls) == (1, 2)
    assert pc_mod.GLOBAL_EXECUTOR_CACHE.stats()["traces"] == 1
