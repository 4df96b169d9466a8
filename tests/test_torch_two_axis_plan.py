"""Two dp axes on the host: planning, pricing and selection against
``repro.core``, request for request.

On ``(pods, d)`` meshes (2, 2), (2, 3), (2, 4) and the other way round,
for every composed name (``ring_rsa×{rhd_rsa,ring_rsa,psum}``, ASCII
``x`` too), ``hierarchical`` and the flat fold of every flat name, bare
and per-level codec specs:

* ``codec.split_spec`` / ``validate_spec`` answer and refuse as the
  reference's;
* ``cost_model``'s two-level terms, ``reducers``' multi-axis closed forms
  and ``schedule.decompose`` / ``strategy_latency`` equal the
  reference's, float for float, on either link;
* ``plan`` over the reduced smollm-360m tree gives the reference's JSON
  and fingerprint (``render`` strings included: ``ring@data×rhd@pod``),
  and ``from_json`` / ``with_fused_hops`` keep them;
* the analytic selector's choices, ``predicted_s``, switch points and
  fingerprints, and the empirical selector's ``axes`` rows and
  nearest-mesh lookup, equal the reference's, and so do the plans they
  make and the aggregator's ``resolve`` on ``("pod", "data")``;
* ``hop_elements`` sizes reduce-scatter and all-gather hops; the
  launcher's ``--mesh`` parses ``DxM`` and ``PxDxM`` (a model axis too)
  and refuses a ``--world`` that disagrees.

Host arithmetic only: no ranks.
"""
import argparse
import json
import math

import jax
import pytest
import torch

from repro.configs import get_spec as jget_spec
from repro.core import AggregatorConfig as JConfig
from repro.core import GradientAggregator as JAgg
from repro.core import PlanCache as JCache
from repro.core import codec as jcodec
from repro.core import cost_model as jcm
from repro.core import reducers as jreducers
from repro.core import schedule as jschedule
from repro.core import selector as JS
from repro.models import build_model as jbuild_model
from repro.models import param_groups as jparam_groups

from repro_torch import tree
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import codec, cost_model as cm, reducers, schedule
from repro_torch.core import selector as S
from repro_torch.core.plan_cache import PlanCache
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import mesh_shape, parser
from repro_torch.models import param_groups

SIZES = ((2, 2), (2, 3), (2, 4), (3, 2), (4, 2))
COMPOSED = ("ring_rsa×rhd_rsa", "ring_rsa×ring_rsa", "ring_rsa×psum",
            "ring_rsaxrhd_rsa", "hierarchical")
FLAT = ("rhd_rsa", "ring_rsa", "psum", "ps_gather")
SPECS = ("none", "int8", "bf16", "bf16×int8", "none×fp8_e4m3",
         "fp8_e4m3xbf16")
NBYTES = (0, 4, 1000, 4096, 123457, 5 << 20)
THRESHOLD = 1 << 18


@pytest.fixture(scope="module")
def shapes():
    spec = jget_spec("smollm-360m").reduced()
    jstruct = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    tstruct = tree.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32), jstruct)
    return jstruct, tstruct


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__,)


@pytest.mark.parametrize("spec", SPECS + ("int8×bf16×none", "int9",
                                          "bf16×gzip", ""))
def test_codec_specs_match_reference(spec):
    assert _outcome(lambda: codec.validate_spec(spec)) == \
        _outcome(lambda: jcodec.validate_spec(spec))
    for levels in (1, 2, 3):
        assert _outcome(lambda: codec.split_spec(spec, levels)) == \
            _outcome(lambda: jcodec.split_spec(spec, levels))


def test_two_level_cost_terms_match_reference():
    for pods, d in SIZES:
        for n in NBYTES:
            for outer in schedule.OUTER_ALGORITHMS:
                assert cm.composed_latency(outer, n, d, pods) == \
                    jcm.composed_latency(outer, n, d, pods)
            assert cm.hierarchical_latency(n, d, pods,
                                           intra=cm.PAPER_LINK) == \
                jcm.hierarchical_latency(n, d, pods, intra=jcm.PAPER_LINK)
            for s in FLAT:
                assert cm.flat_multiaxis_latency(s, n, d, pods) == \
                    jcm.flat_multiaxis_latency(s, n, d, pods)
    with pytest.raises(ValueError, match="hierarchical_latency"):
        cm.allreduce_latency("hierarchical", 1024, 4)


@pytest.mark.parametrize("strategy", FLAT + ("hierarchical",))
def test_multi_axis_closed_forms_match_reference(strategy):
    for sizes in SIZES + ((2, 2, 2), (1, 4), (5,)):
        for n in NBYTES:
            assert _outcome(lambda: reducers.wire_bytes(strategy, n, sizes)) \
                == _outcome(lambda: jreducers.wire_bytes(strategy, n, sizes))
        assert _outcome(lambda: reducers.allreduce_steps(strategy, sizes)) \
            == _outcome(lambda: jreducers.allreduce_steps(strategy, sizes))
    for pods, d in SIZES:
        assert reducers.hierarchical_wire_bytes(12345, d, pods) == \
            jreducers.hierarchical_wire_bytes(12345, d, pods)


def _stage_json(stages):
    return [st.to_json() for st in stages]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("strategy", COMPOSED + FLAT)
def test_decompose_and_latency_match_reference(strategy, spec, fused):
    for sizes in SIZES:
        for n in NBYTES:
            kw = dict(codec=spec, fused=fused)
            got = _outcome(lambda: _stage_json(schedule.decompose(
                strategy, n, ("pod", "data"), sizes, **kw)))
            want = _outcome(lambda: _stage_json(jschedule.decompose(
                strategy, n, ("pod", "data"), sizes, **kw)))
            assert got == want, (sizes, n)
            links = dict(intra="paper")
            assert _outcome(lambda: schedule.strategy_latency(
                strategy, n, sizes, codec=spec, fused=fused, **links)) == \
                _outcome(lambda: jschedule.strategy_latency(
                    strategy, n, sizes, codec=spec, fused=fused, **links))


@pytest.mark.parametrize("spec", ("none", "int8", "bf16×int8"))
@pytest.mark.parametrize("strategy", COMPOSED + FLAT)
@pytest.mark.parametrize("sizes", SIZES[:3])
def test_plan_json_and_fingerprint_match_reference(shapes, sizes, strategy,
                                                   spec):
    jstruct, tstruct = shapes
    kw = dict(axis_names=("pod", "data"), axis_sizes=sizes,
              strategy=strategy, threshold_bytes=THRESHOLD, codec=spec)
    ref = jschedule.plan(jstruct, groups=jparam_groups(jstruct), **kw)
    got = schedule.plan(tstruct, groups=param_groups(tstruct), **kw)
    assert json.dumps(got.to_json()) == json.dumps(ref.to_json())
    assert got.render() == ref.render()
    assert [b.render() for b in got.buckets] == \
        [b.render() for b in ref.buckets]
    assert got.fingerprint() == ref.fingerprint()
    assert got.fingerprint(detached=True) == ref.fingerprint(detached=True)
    back = schedule.from_json(got.to_json())
    assert back.fingerprint(detached=True) == \
        got.fingerprint(detached=True)
    assert json.dumps(back.to_json()) == json.dumps(
        jschedule.from_json(ref.to_json()).to_json())
    assert json.dumps(schedule.with_fused_hops(got).to_json()) == \
        json.dumps(jschedule.with_fused_hops(ref).to_json())


def test_composed_render_strings():
    st = schedule.decompose("hierarchical", 4096, ("pod", "data"), (2, 2),
                            codec="bf16×int8", fused=True)
    b = schedule.BucketSchedule(0, (), 1024, 4096, 0,
                                "ring_rsa×rhd_rsa", st, 0.0)
    assert b.render() == "ring@data:bf16×rhd@pod:int8"
    assert [(s.op, s.axis, s.codec, s.fused_hop) for s in st] == [
        ("reduce_scatter", "data", "bf16", True),
        ("allreduce", "pod", "int8", True),
        ("all_gather", "data", "bf16", False)]
    flat = schedule.decompose("rhd_rsa", 4096, ("pod", "data"), (2, 2),
                              codec="bf16×int8")
    assert [(s.axis, s.codec) for s in flat] == [("data", "bf16"),
                                                 ("pod", "int8")]


ANALYTIC = {
    "ici": (lambda m: m.AnalyticSelector(), "none"),
    "paper_dcn": (lambda m: m.AnalyticSelector(link="paper"), "none"),
    "paper_bf16xint8": (lambda m: m.AnalyticSelector(link="paper",
                                                     codec="bf16×int8"),
                        "bf16×int8"),
    "int8_fused": (lambda m: m.AnalyticSelector(codec="int8", fused=True),
                   "int8"),
    "bf16xint8_fused": (lambda m: m.AnalyticSelector(codec="bf16×int8",
                                                     fused=True),
                        "bf16×int8"),
}


@pytest.mark.parametrize("case", list(ANALYTIC))
def test_analytic_two_axis_selection_matches_reference(case):
    make, _ = ANALYTIC[case]
    got, want = make(S), make(JS)
    assert got.fingerprint() == want.fingerprint()
    for sizes in SIZES:
        assert got.candidates_for(sizes) == want.candidates_for(sizes)
        assert got.switch_points(sizes) == want.switch_points(sizes)
        assert got.crossover_table(sizes) == want.crossover_table(sizes)
        for n in (256, 3000, 1 << 16, 123457, 5 << 20, 1 << 28):
            a, b = got.choose(n, sizes), want.choose(n, sizes)
            assert (a.strategy, a.predicted_s) == (b.strategy, b.predicted_s)
            for s in got.candidates_for(sizes) + ("hierarchical",):
                assert S.predict_latency(s, n, sizes, got.link,
                                         codec=got.codec,
                                         fused=got.fused) == \
                    JS.predict_latency(s, n, sizes, want.link,
                                       codec=want.codec, fused=want.fused)


def _axes_table(m):
    """``axes`` rows for 2 × 2 and 2 × 4 (a flat fold below 32 KiB, the
    composed schedule above, psum past 1 MiB on 2 × 4) and plain ``p``
    rows for 8."""
    e = [{"p": 4, "axes": [2, 2], "bytes": 0,
          "latency_us": {"rhd_rsa": 1.0, "ring_rsa×rhd_rsa": 5.0}},
         {"p": 4, "axes": [2, 2], "bytes": 32768,
          "latency_us": {"ring_rsa×rhd_rsa": 1.0, "rhd_rsa": 5.0}},
         {"p": 8, "axes": [2, 4], "bytes": 0,
          "latency_us": {"hierarchical": 1.0, "ring_rsa": 2.0}},
         {"p": 8, "axes": [2, 4], "bytes": 1 << 20,
          "latency_us": {"psum": 1.0, "ring_rsa×ring_rsa": 2.0}}]
    return {"schema": m.TABLE_SCHEMA, "entries": e}


def _p_table(m):
    return {"schema": m.TABLE_SCHEMA, "entries": [
        {"p": 8, "bytes": 0, "latency_us": {"rhd_rsa": 1.0}},
        {"p": 8, "bytes": 4096, "latency_us": {"ring_rsa": 1.0}},
        {"p": 4, "axes": [2, 2], "bytes": 0,
         "latency_us": {"ring_rsa×psum": 1.0, "rhd_rsa": 3.0}}]}


@pytest.mark.parametrize("table", [_axes_table, _p_table])
def test_empirical_axes_rows_match_reference(table):
    got, want = S.EmpiricalSelector(table(S)), JS.EmpiricalSelector(table(JS))
    assert got.fingerprint() == want.fingerprint()
    for sizes in SIZES + ((4,), (8,), (3,), (1, 3)):
        assert got.switch_points(sizes) == want.switch_points(sizes)
        for n in (0, 100, 32768, 40000, 1 << 20, 1 << 22):
            a, b = _outcome(lambda: got.choose(n, sizes)), \
                _outcome(lambda: want.choose(n, sizes))
            if a[0] == "ok":
                a = ("ok", a[1].strategy, a[1].predicted_s)
                b = ("ok", b[1].strategy, b[1].predicted_s)
            assert a == b, (sizes, n)


@pytest.mark.parametrize("case", ["analytic", "analytic_int8", "axes",
                                  "axes_bf16xint8"])
def test_plan_and_resolve_with_selector_match_reference(shapes, tmp_path,
                                                        case):
    jstruct, tstruct = shapes
    codec_spec = {"analytic_int8": "int8",
                  "axes_bf16xint8": "bf16×int8"}.get(case, "none")
    if case.startswith("axes"):
        path = str(tmp_path / "table.json")
        S.save_table(_axes_table(S), path)
        cfg = dict(strategy="auto", selector_mode="empirical",
                   selector_table=path)
    else:
        cfg = dict(strategy="auto")
    cfg.update(codec=codec_spec, fusion_threshold_mb=0.25)
    for sizes in ((2, 2), (2, 4)):
        ref = JAgg(JConfig(**cfg), ("pod", "data"), cache=JCache()).resolve(
            jstruct, sizes, groups=jparam_groups(jstruct))
        got = GradientAggregator(
            AggregatorConfig(**cfg), ("pod", "data"),
            {"pod": Group(name="pod"), "data": Group()},
            cache=PlanCache()).resolve(tstruct, sizes,
                                       groups=param_groups(tstruct))
        assert json.dumps(got.to_json()) == json.dumps(ref.to_json()), sizes


def test_mixed_axes_table_mixes_a_fold_and_the_composed_schedule(shapes,
                                                                 tmp_path):
    """The reference's forced ``axes`` table on the reduced tree at
    2 × 2: a flat fold for the small buckets, the composed schedule for
    the large ones, switch point at 32 KiB."""
    _, tstruct = shapes
    sel = S.EmpiricalSelector(_axes_table(S))
    sched = schedule.plan(tstruct, axis_names=("pod", "data"),
                          axis_sizes=(2, 2), selector=sel,
                          threshold_bytes=THRESHOLD,
                          groups=param_groups(tstruct))
    assert set(sched.strategies()) == {"rhd_rsa", "ring_rsa×rhd_rsa"}
    assert sched.switch_points == (32768,)
    for b in sched.buckets:
        assert (b.n_bytes >= 32768) == (b.strategy == "ring_rsa×rhd_rsa")
        assert b.render() == ("ring@data×rhd@pod" if b.n_bytes >= 32768
                              else "rhd@data×rhd@pod")


@pytest.mark.parametrize("alg,p,shape,want", [
    ("ring_rsa", 2, (37,), (19, 0)),
    ("ring_rsa", 3, (5, 4), (8, 0)),
    ("rhd_rsa", 3, (19,), (20, 0)),
    ("rhd_rsa", 2, (19, 2), (20, 0)),
    ("ps_gather", 2, (19, 2), (0, 38)),
    ("psum", 4, (19,), (0, 0)),
])
def test_hop_elements_of_reduce_scatter_and_all_gather(alg, p, shape, want):
    """A reduce-scatter's hops carry a chunk of its input's padded rows,
    as the allreduce's first ring hop does; an all-gather's its whole
    input (the chunk).  A ``shard`` has none."""
    assert reducers.hop_elements(alg, shape, p) == want
    if alg == "ring_rsa":
        assert reducers.hop_elements(alg, shape, p, op="reduce_scatter") \
            == want
        chunk = (want[0] // math.prod(shape[1:]),) + shape[1:]
        assert reducers.hop_elements(alg, chunk, p, op="all_gather") == \
            (want[0], 0)
    assert reducers.hop_elements(alg, shape, p, op="shard") == (0, 0)
    assert reducers.hop_elements("ring_rsa", shape, 1, op="all_gather") \
        == (0, 0)
    with pytest.raises(ValueError):
        reducers.hop_elements("rhd_rsa", shape, p, op="all_gather")


@pytest.mark.parametrize("mesh,world,want", [
    (None, None, (0, 1, 1)), (None, 4, (0, 4, 1)), ("4x1", None, (0, 4, 1)),
    ("2x2x1", None, (2, 2, 1)), ("2x2x1", 4, (2, 2, 1)),
    ("3x2x1", 6, (3, 2, 1)), ("2x2", None, (0, 2, 2)),
    ("2x2x2", 8, (2, 2, 2)), ("4x2", None, (0, 4, 2)),
])
def test_mesh_flag_parses(mesh, world, want):
    args = parser().parse_args(["--arch", "smollm-360m"])
    args.mesh, args.world = mesh, world
    assert mesh_shape(args) == want


@pytest.mark.parametrize("mesh,world", [
    ("2x2x2", 4), ("4x2", 4), ("2x2x1", 8), ("2x0x1", None),
    ("2xx1", None), ("2", None),
])
def test_mesh_flag_refuses(mesh, world):
    """A ``--world`` that disagrees with the mesh (model axis included)
    and malformed meshes; a model axis above 1 parses (above)."""
    args = argparse.Namespace(mesh=mesh, world=world)
    with pytest.raises(ValueError):
        mesh_shape(args)


def test_groups_without_a_process_group():
    """A single process is the 1 × 1 mesh; ``dp_axes_of`` keeps the dp
    axes outermost first, as the reference's does of a mesh."""
    groups = mesh_mod.make_groups(1, 1)
    assert list(groups) == ["pod", "data"]
    assert all(g.size == 1 for g in groups.values())
    with pytest.raises(ValueError):
        mesh_mod.make_groups(2, 2)
    assert mesh_mod.dp_axes_of(("pod", "data", "model")) == ("pod", "data")
    assert mesh_mod.dp_axes_of(("data", "model")) == ("data",)
