"""Telemetry: the port's ``repro_torch.telemetry`` against ``repro.telemetry``.

Host only, no ranks.  The reference's unit cases
(``tests/test_telemetry.py``) restated for the port — spans, the trace
schema, the metrics registry, the closure's calibration and residual
band, ``measured_timeline`` and the artifact check — and held to the
reference across packages:

* a port trace loads through the reference's ``from_json``, and back;
* ``schedule.synthetic`` gives the reference's ``to_json()`` and
  fingerprint for the artifact cells and a bracketed case, and the IR
  paths of an attached plan are the reference's;
* ``record_schedule`` snapshots are equal for the same plan;
* ``closure_report`` and ``measured_timeline`` are equal float for float
  on the same schedule and measurements;
* the port's ``check_artifact`` passes the reference's committed
  ``BENCH_telemetry.json`` (read, never written).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtelemetry
from repro.core import AggregatorConfig as JConfig
from repro.core import GradientAggregator as JAgg
from repro.core import PlanCache as JCache
from repro.core import schedule as jschedule
from repro.telemetry import closure as jclosure
from repro.telemetry import metrics as jmetrics
from repro.telemetry import trace as jtrace

from repro_torch import telemetry
from repro_torch.core import AggregatorConfig, GradientAggregator, Group
from repro_torch.core import overlap, plan_cache, schedule
from repro_torch.telemetry import closure, metrics as metrics_mod, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_ARTIFACT = os.path.join(ROOT, "BENCH_telemetry.json")


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    """Tests flip the process-global tracers; always restore 'off'."""
    yield
    telemetry.configure(trace.TelemetryConfig(enabled=False))
    telemetry.METRICS.reset()
    jtelemetry.configure(jtrace.TelemetryConfig(enabled=False))
    jtelemetry.METRICS.reset()


def _on():
    return trace.Tracer(trace.TelemetryConfig(enabled=True))


# ---------------------------------------------------------------------------
# spans + trace schema
# ---------------------------------------------------------------------------

def test_disabled_span_is_shared_null_object():
    tracer = trace.Tracer(trace.TelemetryConfig(enabled=False))
    s1 = tracer.span("a", cat="trace", ir_path="bucket[0]")
    s2 = tracer.span("b")
    assert s1 is s2 is trace._NULL_SPAN
    with s1 as sp:
        sp.set("k", 1)
    assert tracer.roots == []


def test_unknown_category_rejected_only_when_enabled():
    with pytest.raises(ValueError):
        _on().span("x", cat="gpu")
    off = trace.Tracer(trace.TelemetryConfig(enabled=False))
    assert off.span("x", cat="gpu") is trace._NULL_SPAN


def test_env_var_and_categories_are_the_reference_s():
    assert trace.ENV_VAR == jtrace.ENV_VAR == "REPRO_TRACE"
    assert trace.CATEGORIES == jtrace.CATEGORIES
    assert trace.TRACE_SCHEMA == jtrace.TRACE_SCHEMA
    assert metrics_mod.METRICS_SCHEMA == jmetrics.METRICS_SCHEMA
    assert metrics_mod.MAX_SAMPLES == jmetrics.MAX_SAMPLES
    assert (closure.TELEMETRY_SCHEMA, closure.BAND_FACTOR,
            closure.MIN_BAND_BYTES, closure.MAX_BAND_BYTES) == \
        (jclosure.TELEMETRY_SCHEMA, jclosure.BAND_FACTOR,
         jclosure.MIN_BAND_BYTES, jclosure.MAX_BAND_BYTES)
    os.environ[trace.ENV_VAR] = "1"
    try:
        assert trace.TelemetryConfig.from_env().enabled
    finally:
        del os.environ[trace.ENV_VAR]
    assert not trace.TelemetryConfig.from_env().enabled


def _nested(tracer):
    with tracer.span("step", cat="wall") as outer:
        with tracer.span("bucket", cat="trace", ir_path="bucket[0]"):
            assert tracer.current_path() == "bucket[0]"
            with tracer.span("stage", cat="trace",
                             ir_path="bucket[0].stage[0]", wire_bytes=128):
                assert tracer.current_path() == "bucket[0].stage[0]"
        with tracer.span("bucket", cat="trace", ir_path="bucket[1]"):
            pass
    return outer


def test_span_nesting_ordering_and_roundtrip():
    tracer = _on()
    outer = _nested(tracer)
    assert len(tracer.roots) == 1
    assert [c.attrs["ir_path"] for c in outer.children] == \
        ["bucket[0]", "bucket[1]"]
    for parent in tracer.iter_spans():
        assert parent.t1 >= parent.t0
        prev_end = parent.t0
        for c in parent.children:
            assert c.t0 >= prev_end - 1e-9
            assert c.t1 <= parent.t1 + 1e-9
            prev_end = c.t0
    rec = tracer.to_json()
    assert rec["schema"] == trace.TRACE_SCHEMA
    back = trace.from_json(json.loads(json.dumps(rec)))
    assert [s.to_json() for s in back] == rec["spans"]
    assert back[0].children[0].children[0].attrs["wire_bytes"] == 128
    with pytest.raises(ValueError):
        trace.from_json({"schema": "repro/other/v9"})


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_trace_records_cross_load(direction):
    """A port ``Tracer.to_json()`` loads through the reference's
    ``from_json`` and back, span for span; and the other way round."""
    if direction == "port_to_reference":
        tracer, load, back = _on(), jtrace.from_json, trace.from_json
    else:
        tracer = jtrace.Tracer(jtrace.TelemetryConfig(enabled=True))
        load, back = trace.from_json, jtrace.from_json
    _nested(tracer)
    rec = json.loads(json.dumps(tracer.to_json()))
    spans = load(rec)
    assert [s.to_json() for s in spans] == rec["spans"]
    again = {"schema": rec["schema"], "spans": [s.to_json() for s in spans]}
    assert [s.to_json() for s in back(again)] == rec["spans"]


def test_exception_unwind_closes_dangling_spans():
    tracer = _on()
    with pytest.raises(RuntimeError):
        with tracer.span("outer"):
            ctx = tracer.span("inner", cat="trace")
            ctx.__enter__()
            raise RuntimeError("boom")
    inner = tracer.roots[0].children[0]
    assert inner.t1 >= inner.t0 > 0
    assert tracer._stack == []


def test_chrome_trace_is_perfetto_shaped(tmp_path):
    tracer = _on()
    with tracer.span("outer", cat="wall"):
        with tracer.span("inner", cat="trace", ir_path="bucket[0]"):
            pass
    path = tmp_path / "trace.json"
    tracer.write(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert len(evs) == 2
    for ev in evs:
        assert ev["ph"] == "X"
        assert ev["ts"] >= 0 and ev["dur"] >= 0
        assert ev["cat"] in trace.CATEGORIES
    assert {ev["tid"] for ev in evs} == {0, 1}
    assert doc["repro"]["schema"] == trace.TRACE_SCHEMA
    assert trace.from_json(doc["repro"])
    assert jtrace.from_json(doc["repro"])


def test_spans_of_another_thread_nest_on_their_own_track():
    """Each thread nests on its own stack: the channel thread's bucket
    span is a root carrying ``thread``, its stage nests under it, and the
    main thread's open span neither adopts them nor sees their path."""
    tracer = _on()
    seen = {}

    def channel():
        with tracer.span("bucket[0]", cat="trace", ir_path="bucket[0]"):
            with tracer.span("stage[0]", cat="trace",
                             ir_path="bucket[0].stage[0]"):
                seen["path"] = tracer.current_path()

    with tracer.span("overlap_params", cat="trace"):
        t = threading.Thread(target=channel, name="overlap-channel")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert tracer.current_path() == ""
    assert seen["path"] == "bucket[0].stage[0]"
    main, bucket = tracer.roots
    assert main.children == [] and "thread" not in main.attrs
    assert bucket.attrs["thread"] == "overlap-channel"
    assert bucket.children[0].attrs["thread"] == "overlap-channel"
    tids = {ev["name"]: ev["tid"]
            for ev in tracer.chrome_trace()["traceEvents"]}
    assert tids == {"overlap_params": 1, "bucket[0]": trace.THREAD_TID,
                    "stage[0]": trace.THREAD_TID}
    tracer.clear()
    assert tracer.roots == [] and tracer._stack == []


def test_timed_call_records_histogram():
    telemetry.configure(trace.TelemetryConfig(enabled=True))
    fn = trace.timed_call(lambda x: {"y": [x * 2]}, "unit.op",
                          histogram="unit_s")
    out = fn(torch.ones((4,)))
    assert float(out["y"][0].sum()) == 8.0
    snap = telemetry.METRICS.snapshot()["metrics"]["unit_s"]["values"][""]
    assert snap["count"] == 1 and snap["min"] >= 0.0
    root = telemetry.get_tracer().roots[0]
    assert root.name == "unit.op" and root.cat == "wall"
    assert root.attrs["synced"] is True
    assert fn.__name__ == "<lambda>"          # attribute access proxied


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_basics():
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("bytes", help="b")
    c.inc(10, algo="ring")
    c.inc(5, algo="ring")
    c.inc(1, algo="rhd")
    assert c.get(algo="ring") == 15 and c.get(algo="rhd") == 1
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("height")
    g.set(3.5)
    g.set(4.5)
    assert g.get() == 4.5
    h = reg.histogram("lat")
    for v in range(100):
        h.observe(float(v))
    assert h.percentile(50) == pytest.approx(50, abs=1)
    assert h.percentile(99) == pytest.approx(98, abs=1)
    snap = reg.snapshot()
    assert snap["schema"] == metrics_mod.METRICS_SCHEMA
    assert snap["metrics"]["lat"]["values"][""]["count"] == 100
    text = reg.render()
    assert "bytes [counter]" in text and "algo=ring" in text


def test_registry_snapshot_and_render_equal_the_reference_s():
    regs = (metrics_mod.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("c", help="x").inc(3, algo="ring", codec="int8")
        reg.gauge("g").set(2.5, field="hits")
        h = reg.histogram("h", help="s")
        for v in (0.3, 0.1, 0.2, 0.7):
            h.observe(v, op="allreduce")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].render() == regs[1].render()


def test_kind_conflict_raises():
    reg = metrics_mod.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_histogram_reservoir_bounded():
    reg = metrics_mod.MetricsRegistry()
    h = reg.histogram("big")
    for v in range(metrics_mod.MAX_SAMPLES + 100):
        h.observe(float(v))
    vals = h.samples[metrics_mod.label_key({})]
    assert len(vals) == metrics_mod.MAX_SAMPLES
    assert vals[0] == 100.0


def test_record_schedule_counts_wire_bytes_by_algorithm():
    reg = metrics_mod.MetricsRegistry()
    sched = schedule.synthetic([1 << 20, 1 << 20], "ring_rsa",
                               axis_sizes=(8,))
    metrics_mod.record_schedule(sched, registry=reg)
    want = sum(st.wire_bytes for _p, _b, st in sched.iter_stages())
    assert reg.counter("schedule_wire_bytes").get(
        algorithm="ring_rsa", codec="none") == want
    assert reg.counter("schedule_stages").get(
        algorithm="ring_rsa", codec="none") == 2


def _plan_pair(strategy, codec, axis_sizes, fusion_mb=0.001):
    """The same leaves planned by the reference's and the port's
    aggregators."""
    shapes = [(16, 16), (40,), (8, 64), (300,)]
    names = ("data",) if len(axis_sizes) == 1 else ("pod", "data")
    jtree = {f"w{i}": jax.ShapeDtypeStruct(s, jnp.float32)
             for i, s in enumerate(shapes)}
    ttree = {f"w{i}": torch.empty(s) for i, s in enumerate(shapes)}
    kw = dict(strategy=strategy, codec=codec, fusion_threshold_mb=fusion_mb)
    jsched = JAgg(JConfig(**kw), names, cache=JCache()).resolve(
        jtree, axis_sizes)
    tsched = GradientAggregator(
        AggregatorConfig(**kw), names,
        {ax: Group(name=ax) for ax in names},
        cache=plan_cache.PlanCache()).resolve(ttree, axis_sizes)
    return jsched, tsched


PLAN_CASES = {"rhd@4": ("rhd_rsa", "none", (4,)),
              "rhd+int8@4": ("rhd_rsa", "int8", (4,)),
              "ring@3": ("ring_rsa", "none", (3,)),
              "composed@2x2": ("ring_rsa×rhd_rsa", "bf16×int8", (2, 2))}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_ir_paths_and_record_schedule_equal_the_reference_s(case):
    jsched, tsched = _plan_pair(*PLAN_CASES[case])
    assert tsched.fingerprint() == jsched.fingerprint()
    assert [(p, b.path, st.to_json()) for p, b, st in tsched.iter_stages()] \
        == [(p, b.path, st.to_json()) for p, b, st in jsched.iter_stages()]
    assert [b.stage_path(0) for b in tsched.buckets] == \
        [b.stage_path(0) for b in jsched.buckets]
    regs = (metrics_mod.MetricsRegistry(), jmetrics.MetricsRegistry())
    metrics_mod.record_schedule(tsched, registry=regs[0])
    jmetrics.record_schedule(jsched, registry=regs[1])
    assert regs[0].snapshot() == regs[1].snapshot()


def test_record_caches_mirror_stats():
    """The plan-cache and executor-cache gauges mirror ``stats()`` as
    the reference's functions do on the same cache."""
    cache = plan_cache.PlanCache()
    tree = {"a": torch.zeros(8), "b": torch.zeros(3)}
    for _ in range(3):
        cache.get_or_build(tree, 64)
    regs = (metrics_mod.MetricsRegistry(), jmetrics.MetricsRegistry())
    metrics_mod.record_plan_cache(cache, registry=regs[0])
    jmetrics.record_plan_cache(cache, registry=regs[1])
    assert regs[0].snapshot() == regs[1].snapshot()
    g = regs[0].gauge("plan_cache")
    assert (g.get(field="hits"), g.get(field="misses"),
            g.get(field="n_builds")) == (2, 1, 1)
    sched = GradientAggregator(AggregatorConfig(fusion_threshold_mb=0.001),
                               ("data",), {"data": Group()},
                               cache=cache).resolve(tree, (1,))
    execs = plan_cache.StageExecutorCache()
    ex = execs.executor_for(sched, {"data": Group()}, "cpu")
    ex(tree)
    execs.executor_for(sched, {"data": Group()}, "cpu")
    for reg, fn in zip(regs, (metrics_mod.record_executor_cache,
                              jmetrics.record_executor_cache)):
        fn(execs, registry=reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    g = regs[0].gauge("executor_cache")
    assert (g.get(field="traces"), g.get(field="calls"),
            g.get(field="hits")) == (1, 1, 1)


# ---------------------------------------------------------------------------
# IR schedules: synthetic
# ---------------------------------------------------------------------------

SYNTHETIC_CASES = {c["name"]: dict(
    bucket_bytes=c["bucket_bytes"], strategy=c["strategy"],
    axis_sizes=tuple(c["axis_sizes"]), axis_names=tuple(c["axis_names"]),
    wire_dtype=c["wire_dtype"], codec=c["codec"])
    for c in jclosure.artifact_cells()}
SYNTHETIC_CASES["bracketed rhd@4×ag@model"] = dict(
    bucket_bytes=[1 << 20, 3000, 7], strategy="rhd_rsa", axis_sizes=(4,),
    axis_names=("data",), model_axis="model", model_axis_size=2)
SYNTHETIC_CASES["composed bf16×int8, bf16 wire"] = dict(
    bucket_bytes=[4 << 20, 96], strategy="hierarchical", axis_sizes=(2, 4),
    codec="bf16×int8", wire_dtype="bfloat16")
SYNTHETIC_CASES["rhd fold at p=6, fp8"] = dict(
    bucket_bytes=[1 << 16, 1 << 22], strategy="rhd_rsa", axis_sizes=(6,),
    codec="fp8_e4m3")


@pytest.mark.parametrize("case", list(SYNTHETIC_CASES))
def test_synthetic_equals_the_reference_s(case):
    kw = SYNTHETIC_CASES[case]
    got = schedule.synthetic(**kw)
    want = jschedule.synthetic(**kw)
    assert got.to_json() == want.to_json()
    assert got.fingerprint() == want.fingerprint()
    assert got.plan is None
    assert [p for p, _b, _s in got.iter_stages()] == \
        [p for p, _b, _s in want.iter_stages()]


# ---------------------------------------------------------------------------
# closure: calibration + residual band
# ---------------------------------------------------------------------------

def test_calibrate_exact_on_proportional_pairs():
    pairs = [(1.0, 250.0), (2.0, 500.0), (4.0, 1000.0)]
    assert closure.calibrate(pairs) == pytest.approx(250.0)
    assert closure.calibrate([]) == 0.0
    skew = [(1.0, 3.0), (2.5, 4.0), (0.3, 9.0)]
    assert closure.calibrate(skew) == jclosure.calibrate(skew)


def _fake_measured(sched, k_by_p):
    return {path: k_by_p[int(st.axis_size)] * st.predicted_s
            for path, _b, st in sched.iter_stages()}


def _pair(bucket_bytes, strategy, axis_sizes, **kw):
    return (schedule.synthetic(bucket_bytes, strategy, axis_sizes=axis_sizes,
                               **kw),
            jschedule.synthetic(bucket_bytes, strategy,
                                axis_sizes=axis_sizes, **kw))


def _perturbed(measured, factor):
    worst = max(measured)
    return {**measured, worst: measured[worst] * factor}


def _huge(sched, measured):
    big = max(sched.iter_stages(), key=lambda t: t[2].wire_bytes)[0]
    return {**measured, big: measured[big] * closure.BAND_FACTOR * 40}


COMPOSED = "ring_rsa×rhd_rsa"
# (schedule args, measured builder, checks on the report)
REPORT_CASES = {
    "proportional_in_band": (
        ([1 << 20, 4 << 20, 16 << 20], "ring_rsa", (8,)), {},
        lambda s: _fake_measured(s, {8: 300.0}),
        lambda r: (r["n_stages"], r["n_gated"], r["all_within_band"],
                   round(r["calibration"]["k"], 9),
                   round(r["max_ratio"], 12)) == (3, 3, True, 300.0, 1.0)),
    "per_axis_size_calibration": (
        ([4 << 20, 16 << 20], COMPOSED, (2, 4)),
        {"axis_names": ("pod", "data")},
        lambda s: _fake_measured(s, {2: 20.0, 4: 900.0}),
        lambda r: r["all_within_band"]
        and r["calibration"]["per_axis_size"]["2"]["k"]
        == pytest.approx(20.0)
        and r["calibration"]["per_axis_size"]["4"]["k"]
        == pytest.approx(900.0)),
    "out_of_band_detected": (
        ([1 << 20, 4 << 20, 16 << 20], "ring_rsa", (8,)), {},
        lambda s: _perturbed(_fake_measured(s, {8: 300.0}),
                             closure.BAND_FACTOR * 40),
        lambda r: not r["all_within_band"]
        and r["max_ratio"] > closure.BAND_FACTOR),
    "small_stages_reported_not_gated": (
        ([1024], "ring_rsa", (8,)), {},
        lambda s: _fake_measured(s, {8: 1e9}),
        lambda r: r["n_stages"] == 1 and r["n_gated"] == 0
        and r["all_within_band"] and r["stages"][0]["gated"] is False),
    "huge_stages_outside_regime_not_gated": (
        ([1 << 20, 256 << 20], "ring_rsa", (8,)), {},
        lambda s: _huge(s, _fake_measured(s, {8: 300.0})),
        lambda r: r["n_gated"] == 1 and r["all_within_band"]
        and r["calibration"]["k"] == pytest.approx(300.0)
        and max(x["wire_bytes"] for x in r["stages"]
                if not x["gated"]) > closure.MAX_BAND_BYTES),
    "rhd_int8_and_bracket_noise": (
        ([300 << 10, 2 << 20, 9 << 20], "rhd_rsa", (4,)),
        {"codec": "int8"},
        lambda s: {p: st.predicted_s * (40.0 + 7 * i % 5)
                   for i, (p, _b, st) in enumerate(s.iter_stages())},
        lambda r: r["n_gated"] >= 1),
}


@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_closure_report_equals_the_reference_s(case):
    args, kw, make, check = REPORT_CASES[case]
    tsched, jsched = _pair(*args, **kw)
    measured = make(tsched)
    assert measured == make(jsched)
    rep = closure.closure_report(tsched, measured)
    assert rep == jclosure.closure_report(jsched, measured)
    assert check(rep)


def test_closure_report_missing_measurement_raises():
    sched = schedule.synthetic([1 << 20], "ring_rsa", axis_sizes=(8,))
    with pytest.raises(KeyError):
        closure.closure_report(sched, {})


@pytest.mark.parametrize("k,scale", [(123.0, 50.0), (7.5, 3.0),
                                     (300.0, 0.2)])
def test_measured_timeline_equals_the_reference_s(k, scale):
    tsched, jsched = _pair([1 << 20, 4 << 20, 64 << 10], "ring_rsa", (8,))
    compute_s = scale * tsched.predicted_s
    measured = {p: k * st.predicted_s * (1 + 0.1 * i)
                for i, (p, _b, st) in enumerate(tsched.iter_stages())}
    tl = closure.measured_timeline(tsched, measured, k, compute_s)
    ref = jclosure.measured_timeline(jsched, measured, k, compute_s)
    assert tl.to_dict() == ref.to_dict()
    assert [(e.task.index, e.start_s, e.end_s) for e in tl.events] == \
        [(e.task.index, e.start_s, e.end_s) for e in ref.events]


def test_measured_timeline_matches_predicted_when_proportional():
    sched = schedule.synthetic([1 << 20, 4 << 20], "ring_rsa",
                               axis_sizes=(8,))
    compute_s = 50 * sched.predicted_s
    measured = _fake_measured(sched, {8: 123.0})
    tl = closure.measured_timeline(sched, measured, 123.0, compute_s)
    ref = overlap.simulate_schedule(sched, compute_s=compute_s)
    assert tl.step_s == pytest.approx(ref.step_s, rel=1e-9)
    assert tl.overlap_fraction == pytest.approx(ref.overlap_fraction,
                                                rel=1e-9)
    with pytest.raises(ValueError):
        closure.measured_timeline(sched, measured, 0.0, compute_s)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def test_reference_artifact_passes_the_port_s_check():
    """The reference's committed closure artifact is current against the
    port's cost model and decomposition, as it is against the
    reference's: the port's check reads it, and writes nothing."""
    before = os.stat(REFERENCE_ARTIFACT).st_mtime_ns
    assert closure.check_artifact(REFERENCE_ARTIFACT) == []
    assert closure.main(["--check", REFERENCE_ARTIFACT]) == 0
    assert os.stat(REFERENCE_ARTIFACT).st_mtime_ns == before


def _drifted(art, kind):
    bad = json.loads(json.dumps(art))
    if kind == "schema":
        bad["schema"] = "repro/telemetry/v0"
    elif kind == "cost model drifted":
        bad["cells"][0]["stages"][0]["predicted_s"] *= 1.5
    elif kind == "re-emit":
        bad["cells"][1]["stages"].pop()
    elif kind == "out of band":
        bad["cells"][2]["stages"][-1]["measured_s"] *= 1e3
    return bad


@pytest.mark.parametrize("kind", ["schema", "cost model drifted",
                                  "re-emit", "out of band", "missing"])
def test_check_artifact_flags_drift(tmp_path, kind):
    with open(REFERENCE_ARTIFACT) as f:
        art = json.load(f)
    p = tmp_path / "a.json"
    if kind != "missing":
        p.write_text(json.dumps(_drifted(art, kind)))
        assert jclosure.check_artifact(str(p)) != []
    problems = closure.check_artifact(str(p))
    assert any(kind in s for s in problems), problems
    assert closure.main(["--check", str(p)]) == 1


def test_artifact_cells_cover_ops_and_codec():
    cells = closure.artifact_cells()
    assert cells == jclosure.artifact_cells()
    assert any(c["codec"] != "none" for c in cells)
    ops = set()
    for c in cells:
        for _p, _b, st in closure.cell_schedule(c).iter_stages():
            ops.add(st.op)
    assert {"allreduce", "reduce_scatter", "all_gather"} <= ops


def test_build_artifact_round_trips_through_both_checks(tmp_path):
    """An artifact built from measurements proportional to the model
    (the port's ``build_artifact``) passes both packages' checks."""
    measured = {}
    for c in closure.artifact_cells():
        sched = closure.cell_schedule(c)
        measured[c["name"]] = {p: 40.0 * st.predicted_s
                               for p, _b, st in sched.iter_stages()}
    art = closure.build_artifact(measured, "a unit test's numbers")
    assert art["all_within_band"] is True
    path = tmp_path / "t.json"
    path.write_text(json.dumps(art))
    assert closure.check_artifact(str(path)) == []
    assert jclosure.check_artifact(str(path)) == []


# ---------------------------------------------------------------------------
# the hooks on one rank
# ---------------------------------------------------------------------------

def _tiny_step(codec="int8"):
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.configs import get_spec
    import dataclasses
    spec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")
    model = build_model(spec)
    opt = adamw(1e-3)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", codec=codec, fusion_threshold_mb=0.25)),
        device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 17)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return step, extras, params, opt.init(params), batch


def test_train_step_is_raw_when_off_and_timed_when_on():
    step, *_ = _tiny_step()
    assert not isinstance(step, trace.TimedFn)
    tracer = telemetry.configure(trace.TelemetryConfig(enabled=True))
    step, extras, params, state, batch = _tiny_step()
    assert isinstance(step, trace.TimedFn)
    step(params, state, batch)
    names = [s.name for s in tracer.roots]
    assert names[-1] == "train.step" and "aggregate.resolve" in [
        s.name for s in tracer.iter_spans()]
    sched = extras["aggregator"].last_schedule
    buckets = [s for s in tracer.iter_spans() if s.name.startswith("bucket[")]
    assert [s.attrs["ir_path"] for s in buckets] == \
        [b.path for b in sched.buckets]
    snap = telemetry.METRICS.snapshot()["metrics"]
    assert snap["train_step_s"]["values"][""]["count"] == 1
    assert snap["schedule_stages"]["values"]
    assert snap["plan_cache"]["values"]["field=misses"] >= 1
