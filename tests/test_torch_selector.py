"""The port's selector (``core/selector.py``), fusion switch points and
``plan(selector=...)`` against the reference's.

* Analytic choices, ``predicted_s``, switch points, crossover tables
  and ``crossover_bytes`` equal ``repro.core.selector``'s over bytes
  256 B to 1 GiB, p ∈ {2, 3, 4, 8}, links ``ici`` and ``paper``, codecs
  none, int8 and bf16, fused hops on and off.
* Empirical tables: built from the cost model, a JSON round trip, the
  same choices as the reference's empirical selector, the garbage
  ``tests/test_selector.py`` rejects rejected, codec rows and
  fingerprints; the reference's committed ``BENCH_allreduce.json`` is a
  valid table (its schema only: its rows are the JAX package's timings
  on host devices, not the card's).
* ``build_plan`` with switch points gives the reference's buckets, in
  leaf bytes and in wire-dtype bytes.
* ``plan(selector=...)``'s JSON equals the reference's on the reduced
  smollm-360m tree; plans under different selectors miss each other in
  the plan cache; ``strategy="auto"`` resolves through the aggregator.
* A composed candidate on one axis and three axes raise the
  reference's ``ValueError`` (two-axis selection is held to the
  reference in ``tests/test_torch_two_axis_plan.py``).  Host arithmetic
  only: no ranks.
"""
import json
import math
import os

import jax
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.core import cost_model as jcm
from repro.core import fusion as jfusion
from repro.core import schedule as jschedule
from repro.core import selector as JS
from repro.models import build_model as jbuild_model
from repro.models import param_groups as jparam_groups

from repro_torch import tree
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import cost_model as cm
from repro_torch.core import fusion, schedule
from repro_torch.core import selector as S
from repro_torch.core.plan_cache import PlanCache
from repro_torch.models import param_groups

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_P = (2, 3, 4, 8)
GRID_BYTES = tuple(1 << k for k in range(8, 31)) + (3000, 123457, 5 << 20)
LINKS = ("ici", "paper")
CODECS = ("none", "int8", "bf16")


def _pair(choice):
    return (choice.strategy, choice.predicted_s)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("link", LINKS)
def test_analytic_choices_match_reference(link, codec, fused):
    got = S.AnalyticSelector(link=link, codec=codec, fused=fused)
    ref = JS.AnalyticSelector(link=link, codec=codec, fused=fused)
    assert got.fingerprint() == ref.fingerprint()
    for p in GRID_P:
        for n in GRID_BYTES:
            assert _pair(got.choose(n, (p,))) == \
                _pair(ref.choose(n, (p,))), (p, n)
            for s in got.candidates:
                assert S.predict_latency(s, n, (p,), got.link, codec=codec,
                                         fused=fused) == \
                    JS.predict_latency(s, n, (p,), ref.link, codec=codec,
                                       fused=fused)
        assert got.switch_points((p,)) == ref.switch_points((p,))
        assert got.switch_points((p,), hi=16 << 20) == \
            ref.switch_points((p,), hi=16 << 20)
        assert got.crossover_table((p,), lo=256, hi=64 << 20) == \
            ref.crossover_table((p,), lo=256, hi=64 << 20)
        assert S.crossover_bytes(p, link=link, codec=codec, fused=fused) \
            == JS.crossover_bytes(p, link=link, codec=codec, fused=fused)


def test_paper_crossover_structure():
    """The reference's pins of the paper's Fig. 6 structure hold on the
    port: RHD below the crossover, ring above; the crossover grows with
    p; power-of-two p has none; a codec moves it up."""
    sel = S.AnalyticSelector(link="paper")
    xs = [S.crossover_bytes(p, link="paper") for p in (3, 6, 12, 24)]
    assert xs[0] == 0.0 and xs[1] < xs[2] < xs[3] < math.inf
    for p in (6, 12, 24):
        c = S.crossover_bytes(p, link="paper")
        assert sel.select(max(1, int(c * 0.5)), (p,)) == "rhd_rsa"
        assert sel.select(int(c * 2), (p,)) == "ring_rsa"
    for p in (2, 4, 8, 16):
        assert S.crossover_bytes(p, link="paper") == math.inf
    ys = [S.crossover_bytes(6, link="paper", codec=c)
          for c in ("none", "bf16", "int8")]
    assert 0 < ys[0] < ys[1] < ys[2] < math.inf
    pts = sel.switch_points((6,), hi=16 << 20)
    assert any(abs(pt - xs[1]) / xs[1] < 0.05 for pt in pts)
    assert sel.switch_points((6,), hi=16 << 20) is pts      # cached


def test_analytic_select_is_cost_model_argmin():
    for link in (cm.ICI, cm.PAPER_LINK, cm.DCN):
        sel = S.AnalyticSelector(link=link)
        for p in GRID_P:
            for n in (8, 4096, 1 << 20, 256 << 20):
                want = min(sel.candidates, key=lambda s: (
                    cm.allreduce_latency(s, n, p, link=link),
                    sel.candidates.index(s)))
                assert sel.select(n, (p,)) == want, (p, n)


def test_ps_gather_never_selected():
    table = {"schema": S.TABLE_SCHEMA, "entries": [
        {"p": 4, "bytes": 0, "latency_us": {"ps_gather": 0.1,
                                            "ring_rsa": 2.0}}]}
    assert S.EmpiricalSelector(table).select(1 << 20, (4,)) == "ring_rsa"
    assert "ps_gather" not in S.DEFAULT_CANDIDATES
    assert S.DEFAULT_CANDIDATES == JS.DEFAULT_CANDIDATES
    assert S.COMPOSED_CANDIDATES == JS.COMPOSED_CANDIDATES
    assert S.TABLE_SCHEMA == JS.TABLE_SCHEMA and S.MODES == JS.MODES
    assert sorted(S.LINK_PROFILES) == sorted(JS.LINK_PROFILES)


def test_empirical_roundtrip_through_json(tmp_path):
    table = S.build_analytic_table(ps=(4, 6, 12),
                                   sizes=(1024, 65536, 1 << 20, 16 << 20),
                                   link="paper")
    assert table == JS.build_analytic_table(
        ps=(4, 6, 12), sizes=(1024, 65536, 1 << 20, 16 << 20),
        link=jcm.PAPER_LINK)
    path = str(tmp_path / "table.json")
    S.save_table(table, path)
    loaded = S.load_table(path)
    assert loaded == json.loads(json.dumps(table))
    emp, ref = S.EmpiricalSelector(loaded), JS.EmpiricalSelector(loaded)
    ana = S.AnalyticSelector(link="paper")
    assert emp.fingerprint() == ref.fingerprint()
    for p in (2, 4, 5, 6, 12, 30):
        for n in (0, 1024, 1030, 65536, 65541, 1 << 20, 16 << 20, 1 << 30):
            assert _pair(emp.choose(n, (p,))) == \
                _pair(ref.choose(n, (p,))), (p, n)
        assert emp.switch_points((p,)) == ref.switch_points((p,))
    for p in (4, 6, 12):
        for n in (1024, 65536, 1 << 20, 16 << 20):
            assert emp.select(n, (p,)) == ana.select(n, (p,))


def _garbage():
    good = S.build_analytic_table(ps=(4,), sizes=(1024,))
    cases = {"schema": (dict(good, schema="nope/v0"), "schema"),
             "empty": ({"schema": S.TABLE_SCHEMA, "entries": []},
                       "entries"),
             "not_object": ([1, 2], "JSON object")}

    def edit(fn, match):
        t = json.loads(json.dumps(good))
        fn(t["entries"])
        return t, match

    cases["strategy"] = edit(
        lambda e: e[0]["latency_us"].update(warp_drive=1.0),
        "unknown strategy")
    cases["bytes"] = edit(lambda e: e[0].update(bytes=-1), "bytes")
    cases["p"] = edit(lambda e: e[0].update(p=0), "'p'")
    cases["duplicate"] = edit(lambda e: e.append(dict(e[0])), "duplicate")
    cases["latency"] = edit(
        lambda e: e[0]["latency_us"].update(rhd_rsa=0.0), "latency_us")
    cases["latency_nan"] = edit(
        lambda e: e[0]["latency_us"].update(rhd_rsa=float("nan")),
        "latency_us")
    cases["codec_name"] = edit(lambda e: e[0].update(codec="int4"),
                               "codec")
    cases["codec_type"] = edit(lambda e: e[0].update(codec=8), "codec")
    cases["axes"] = edit(lambda e: e[0].update(axes=[2, 3]), "axes")
    cases["codec_dup"] = edit(
        lambda e: e.extend([dict(e[0], codec="int8"),
                            dict(e[0], codec="int8")]), "duplicate")
    return cases


@pytest.mark.parametrize("case", list(_garbage()))
def test_validate_table_rejects_what_the_reference_rejects(case):
    table, match = _garbage()[case]
    with pytest.raises(ValueError):
        JS.validate_table(table)
    with pytest.raises(ValueError, match=match):
        S.validate_table(table)


def test_validate_table_accepts_what_the_reference_accepts():
    good = S.build_analytic_table(ps=(4,), sizes=(1024,))
    two = json.loads(json.dumps(good))
    two["entries"].append(dict(two["entries"][0], codec="int8"))
    axes = json.loads(json.dumps(good))
    axes["entries"].append({"p": 8, "axes": [2, 4], "bytes": 0,
                            "latency_us": {"ring_rsa×rhd_rsa": 1.0,
                                           "hierarchical": 2.0}})
    for t in (good, two, axes):
        JS.validate_table(t)
        S.validate_table(t)


def test_empirical_selector_reads_codec_rows():
    table = {"schema": S.TABLE_SCHEMA, "entries": [
        {"p": 8, "bytes": 0,
         "latency_us": {"rhd_rsa": 1.0, "ring_rsa": 2.0}},
        {"p": 8, "bytes": 0, "codec": "int8",
         "latency_us": {"ring_rsa": 1.0, "rhd_rsa": 2.0}}]}
    for c in ("none", "int8", "bf16"):
        assert S.EmpiricalSelector(table, codec=c).select(1024, (8,)) == \
            JS.EmpiricalSelector(table, codec=c).select(1024, (8,))
        assert S.EmpiricalSelector(table, codec=c).fingerprint() == \
            JS.EmpiricalSelector(table, codec=c).fingerprint()
    assert len({S.EmpiricalSelector(table, codec=c).fingerprint()
                for c in ("none", "int8", "bf16")}) == 3


def test_bench_artifact_is_a_valid_tuning_table():
    """The reference's committed table loads; its choices equal the
    reference's (its rows time the JAX package on host devices, so no
    card run selects from it)."""
    path = os.path.join(ROOT, "BENCH_allreduce.json")
    table = S.load_table(path)
    emp, ref = S.EmpiricalSelector(table), JS.EmpiricalSelector(table)
    for p in table["meta"]["ps"]:
        for n in (1024, 1 << 20, 64 << 20):
            assert emp.select(n, (p,)) in S.DEFAULT_CANDIDATES
            assert _pair(emp.choose(n, (p,))) == _pair(ref.choose(n, (p,)))
        assert emp.switch_points((p,)) == ref.switch_points((p,))


def test_make_selector_and_config_validation():
    assert S.make_selector("analytic").mode == "analytic"
    with pytest.raises(ValueError, match="tuning table"):
        S.make_selector("empirical")
    with pytest.raises(ValueError, match="mode"):
        S.make_selector("vibes")
    with pytest.raises(ValueError, match="link"):
        S.AnalyticSelector(link="warp")
    AggregatorConfig(strategy="auto").validate()
    AggregatorConfig(strategy="auto", overlap=True).validate()
    with pytest.raises(ValueError, match="selector_table"):
        AggregatorConfig(strategy="auto",
                         selector_mode="empirical").validate()
    with pytest.raises(ValueError, match="selector_mode"):
        AggregatorConfig(selector_mode="vibes").validate()
    with pytest.raises(ValueError, match="selector_link"):
        AggregatorConfig(selector_link="warp").validate()
    with pytest.raises(ValueError, match="strategy"):
        AggregatorConfig(strategy="nope").validate()
    cfg = AggregatorConfig(strategy="auto", codec="int8", wire_dtype="bfloat16")
    from repro.core.aggregator import AggregatorConfig as JConfig
    want = JConfig(strategy="auto", codec="int8",
                   wire_dtype="bfloat16").make_selector()
    assert cfg.make_selector().fingerprint() == want.fingerprint()
    assert AggregatorConfig().make_selector() is None


def test_two_axis_and_composed_selection_raise():
    """What still raises in selection, as in the reference: a composed
    candidate on one axis (``ValueError``: it needs two) and three axes
    (``ValueError``).  Two-axis selection itself answers."""
    sel = S.AnalyticSelector()
    with pytest.raises(ValueError, match="needs a 2-axis mesh"):
        S.AnalyticSelector(candidates=S.COMPOSED_CANDIDATES).choose(1024,
                                                                    (4,))
    with pytest.raises(ValueError, match="needs a 2-axis mesh"):
        S.predict_latency("ring_rsa×rhd_rsa", 1024, (4,))
    with pytest.raises(ValueError, match="1- or 2-axis"):
        sel.choose(1024, (2, 2, 2))
    with pytest.raises(ValueError, match="1- or 2-axis"):
        S.predict_latency("rhd_rsa", 1024, (2, 2, 2))
    assert sel.choose(1024, (2, 4)).strategy in \
        S.DEFAULT_CANDIDATES + S.COMPOSED_CANDIDATES
    assert isinstance(sel.switch_points((2, 4)), tuple)
    emp = S.EmpiricalSelector(S.build_analytic_table(ps=(4,), sizes=(0,)))
    assert emp.choose(1024, (2, 2)).strategy == "rhd_rsa"


# ---------------------------------------------------------------------------
# Fusion switch points
# ---------------------------------------------------------------------------

def _leaves(n, dtype):
    jt = {f"l{i}": jax.ShapeDtypeStruct((10240,), dtype) for i in range(n)}
    tt = {f"l{i}": torch.empty((10240,), dtype=getattr(torch, dtype))
          for i in range(n)}
    return jt, tt


def _same_buckets(a, b):
    return [(bk.leaf_indices, bk.size) for bk in a.buckets] == \
        [(bk.leaf_indices, bk.size) for bk in b.buckets]


@pytest.mark.parametrize("dtype,itemsize,switch", [
    ("float32", 0, (100 * 1024,)),
    ("bfloat16", 0, (100 * 1024,)),
    ("bfloat16", 4, (100 * 1024,)),
    ("float32", 4, (50 * 1024, 130 * 1024, 170 * 1024)),
    ("float32", 2, (3000, 61440)),
])
def test_build_plan_switch_points_match_reference(dtype, itemsize, switch):
    jt, tt = _leaves(6, dtype)
    ref = jfusion.build_plan(jt, 1 << 20, switch_points=switch,
                             switch_itemsize=itemsize)
    got = fusion.build_plan(tt, 1 << 20, switch_points=switch,
                            switch_itemsize=itemsize)
    assert _same_buckets(got, ref)
    assert got.switch_points == ref.switch_points
    base = fusion.build_plan(tt, 1 << 20)
    if dtype == "float32" and switch == (100 * 1024,):
        assert len(base.buckets) == 1
        assert [b.size * 4 for b in got.buckets] == [80 * 1024] * 3


# ---------------------------------------------------------------------------
# plan(selector=...) and the plan cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes():
    spec = jget_spec("smollm-360m").reduced()
    jstruct = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    tstruct = tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32), jstruct)
    return jstruct, tstruct


def _forced_table():
    return {"schema": S.TABLE_SCHEMA, "entries": [
        {"p": 4, "bytes": 0, "latency_us": {"rhd_rsa": 1.0, "psum": 5.0,
                                            "ring_rsa": 3.0}},
        {"p": 4, "bytes": 100000, "latency_us": {"ring_rsa": 1.0,
                                                 "rhd_rsa": 5.0}},
        {"p": 4, "bytes": 600000, "latency_us": {"psum": 1.0,
                                                 "rhd_rsa": 5.0}}]}


SELECTORS = {
    "ici_p4": (lambda m: m.AnalyticSelector(), 4, "none"),
    "paper_p6": (lambda m: m.AnalyticSelector(link="paper"), 6, "none"),
    "paper_p6_int8": (lambda m: m.AnalyticSelector(
        link="paper", codec="int8", fused=True), 6, "int8"),
    "ici_p3_bf16": (lambda m: m.AnalyticSelector(codec="bf16", fused=True),
                    3, "bf16"),
    "forced_p4": (lambda m: m.EmpiricalSelector(_forced_table()), 4,
                  "none"),
    "forced_p4_int8": (lambda m: m.EmpiricalSelector(_forced_table(),
                                                     codec="int8"), 4,
                       "int8"),
}


@pytest.mark.parametrize("threshold", [1 << 16, 4 << 20])
@pytest.mark.parametrize("case", list(SELECTORS))
def test_plan_with_selector_matches_reference(shapes, case, threshold):
    jstruct, tstruct = shapes
    make, p, codec = SELECTORS[case]
    kw = dict(axis_names=("data",), axis_sizes=(p,), strategy="rhd_rsa",
              threshold_bytes=threshold, codec=codec)
    ref = jschedule.plan(jstruct, groups=jparam_groups(jstruct),
                         selector=make(JS), **kw)
    got = schedule.plan(tstruct, groups=param_groups(tstruct),
                        selector=make(S), **kw)
    assert json.dumps(got.to_json()) == json.dumps(ref.to_json())
    assert got.fingerprint() == ref.fingerprint()
    if case.startswith("forced"):
        assert len(got.strategies()) > 1
        # switch points below the threshold only (the table's are at
        # 100000 and 600000 bytes)
        assert got.switch_points == ((100000, 600000)
                                     if threshold > 600000 else ())
    no_align = schedule.plan(tstruct, groups=param_groups(tstruct),
                             selector=make(S), align_buckets=False, **kw)
    assert json.dumps(no_align.to_json()) == json.dumps(jschedule.plan(
        jstruct, groups=jparam_groups(jstruct), selector=make(JS),
        align_buckets=False, **kw).to_json())


def test_plans_under_different_selectors_miss_each_other(shapes):
    _, tstruct = shapes
    cache = PlanCache()
    t1 = S.build_analytic_table(ps=(4,), sizes=(0, 1 << 20))
    t2 = _forced_table()
    kw = dict(axis_names=("data",), axis_sizes=(4,), cache=cache,
              groups=param_groups(tstruct))
    a = schedule.plan(tstruct, selector=S.EmpiricalSelector(t1), **kw)
    b = schedule.plan(tstruct, selector=S.EmpiricalSelector(t2), **kw)
    c = schedule.plan(tstruct, selector=S.AnalyticSelector(), **kw)
    d = schedule.plan(tstruct, selector=S.AnalyticSelector(link="paper"),
                      **kw)
    e = schedule.plan(tstruct, strategy="rhd_rsa", **kw)
    assert cache.stats.misses == 5 and cache.stats.hits == 0
    assert len({id(x) for x in (a, b, c, d, e)}) == 5
    again = schedule.plan(tstruct, selector=S.EmpiricalSelector(t2), **kw)
    assert again is b and cache.stats.hits == 1


def test_auto_resolves_through_the_aggregator(shapes, tmp_path):
    """``strategy="auto"`` in the aggregator plans what the reference's
    aggregator plans, analytic and empirical."""
    from repro.core import AggregatorConfig as JConfig
    from repro.core import GradientAggregator as JAgg
    from repro.core import PlanCache as JCache
    jstruct, tstruct = shapes
    path = str(tmp_path / "table.json")
    S.save_table(_forced_table(), path)
    for kw in (dict(), dict(codec="int8"),
               dict(selector_mode="empirical", selector_table=path),
               dict(selector_link="paper", fusion_threshold_mb=0.06)):
        cfg = dict(strategy="auto", **kw)
        ref = JAgg(JConfig(**cfg), ("data",), cache=JCache()).resolve(
            jstruct, (4,), groups=jparam_groups(jstruct))
        got = GradientAggregator(AggregatorConfig(**cfg), ("data",),
                                 {"data": Group()}, cache=PlanCache()) \
            .resolve(tstruct, (4,), groups=param_groups(tstruct))
        assert json.dumps(got.to_json()) == json.dumps(ref.to_json()), kw


def test_strategy_latency_matches_reference():
    for strategy in ("rhd_rsa", "ring_rsa", "psum", "ps_gather"):
        for p in GRID_P:
            for n in (0, 1000, 1 << 20, 3.5e6):
                for codec in CODECS:
                    assert schedule.strategy_latency(
                        strategy, n, (p,), codec=codec, fused=True) == \
                        jschedule.strategy_latency(strategy, n, (p,),
                                                   codec=codec, fused=True)
