"""Telemetry on gloo ranks against the reference's traced spans.

One JAX subprocess with 4 host devices, started first, traces the
reference's snippet model (``tests/test_telemetry.py``: three 16×16
tanh layers, ``rhd_rsa``, ``fusion_threshold_mb=0.0005``) with telemetry
on: post-backward, with ``int8`` and overlapped.  It only traces (the
reference's compiled-HLO text comparison is not used).  Meanwhile one
spawn of 4 gloo ranks (file rendezvous) runs the same model through the
port's aggregator with telemetry on.  Checks:

* the span forests are the reference's: ``aggregate.resolve``, then
  ``aggregate`` > ``bucket[i]`` > ``stage[j]`` > ``hop[k]``, names and
  attributes equal on every span except the stage spans'
  ``hlo_kind``/``hlo_bytes`` (the port has no HLO), so every IR bucket,
  stage and hop path has its span, with the IR's wire bytes;
* overlapped, every bucket span is opened on the channel's thread
  (``thread="overlap-channel"``, its own Perfetto track) and equals the
  reference's in-backward bucket span; the gradients are bit for bit
  the post-backward ones;
* disabled-mode identity: 3 steps of the reduced float32 smollm-360m
  (``rhd_rsa`` + ``int8``) with telemetry off, then on, give bit-identical
  parameters, the same plan fingerprint and the same kernel launch
  counters; off, nothing is recorded and ``tracer.span`` is the shared
  null object; on, ``train.step`` has 3 spans and ``train_step_s`` 3
  samples;
* the closure on a p = 4 plan (gloo, and a ``cuda_ipc`` view of the
  group: shared-memory slots here) and a 2 × 2 composed plan:
  ``measure_schedule`` covers every path with positive times, the same
  on every rank; ``measure_fused_replay``'s fused route is within
  ``tests/test_fused_hop.py``'s 2⁻²⁰·absmax of the unfused one.

About 25 s on 6 cores.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import dist, schedule
from repro_torch.telemetry import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
D = 16
FUSION_MB = 0.0005
STEPS = 3
FMA_REL = 2.0 ** -20            # tests/test_fused_hop.py's bound
# (label, codec, overlap) of the snippet runs, on both packages
RUNS = (("rhd", "none", False), ("rhd+int8", "int8", False),
        ("rhd overlap", "none", True))
HLO_KEYS = ("hlo_kind", "hlo_bytes")
# What the port's transport records on a hop span (core/dist.py), for
# the hop lint: the reference has no counterpart.
SENT_KEYS = ("kind", "sent_bytes", "sent_dtype", "sent_parts")


def _inputs():
    rng = np.random.default_rng(7)
    params = {f"w{i}": (rng.standard_normal((D, D)) * 0.3)
              .astype(np.float32) for i in range(3)}
    x = rng.standard_normal((P * 2, D)).astype(np.float32)
    return params, x


_JAX_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from devflags import force_host_devices
force_host_devices(4)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import telemetry
from repro.core import AggregatorConfig, GradientAggregator, PlanCache
from repro.core.compat import make_mesh, shard_map
from repro.telemetry import trace

data = np.load(sys.argv[2])
params = {k: jnp.asarray(data[k]) for k in ("w0", "w1", "w2")}
x = jnp.asarray(data["x"])
runs = json.loads(sys.argv[3])
mesh = make_mesh((4,), ("data",))

def loss(params, x):
    h = x
    for k in sorted(params):
        h = jnp.tanh(h @ params[k])
    return jnp.sum(h * h)

out = {}
for label, codec, overlap in runs:
    tracer = telemetry.configure(trace.TelemetryConfig(enabled=True))
    agg = GradientAggregator(
        AggregatorConfig(strategy="rhd_rsa", fusion_threshold_mb=%r,
                         codec=codec, overlap=overlap),
        ("data",), cache=PlanCache())
    if overlap:
        def local(params, x):
            return jax.grad(lambda q: loss(agg.overlap_params(q), x))(params)
    else:
        def local(params, x):
            return agg(jax.grad(loss)(params, x))
    fn = jax.jit(shard_map(local, mesh, in_specs=(P(), P("data")),
                           out_specs=P(), axis_names={"data"},
                           check_vma=False))
    fn.lower(params, x)                  # tracing records the spans
    out[label] = {"spans": tracer.to_json(),
                  "schedule": agg.last_schedule.to_json()}
print("RESULT " + json.dumps(out))
""" % FUSION_MB


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _loss(params, x):
    h = x
    for k in sorted(params):
        h = torch.tanh(h @ params[k])
    return (h * h).sum()


def _snippet(rank, np_params, x_all, codec, overlap):
    from repro_torch.core import (AggregatorConfig, GradientAggregator,
                                  Group, plan_cache)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in np_params.items()}
    x = torch.from_numpy(x_all[rank * 2:(rank + 1) * 2])
    agg = GradientAggregator(
        AggregatorConfig(strategy="rhd_rsa", fusion_threshold_mb=FUSION_MB,
                         codec=codec, overlap=overlap),
        ("data",), {"data": Group()}, cache=plan_cache.PlanCache())
    if overlap:
        grads = agg.overlap_params(params).backward(_loss(params, x))
    else:
        _loss(params, x).backward()
        grads = agg({k: v.grad for k, v in params.items()})
    return ({k: g.detach().numpy().copy() for k, g in grads.items()},
            agg.last_schedule.to_json())


def _counters():
    from repro_torch.kernels import (flash_attention, fused_adamw,
                                     fused_hop, fused_rmsnorm)
    from repro_torch.kernels.fused_reduce import fused_reduce
    fns = (fused_hop.hop_absmax, fused_hop.hop_encode,
           fused_hop.hop_decode_add, fused_reduce,
           fused_adamw.adamw_update, fused_rmsnorm.fused_rmsnorm,
           flash_attention.flash_attention_fwd,
           flash_attention.flash_attention_bwd)
    return {fn.__name__: fn.launches for fn in fns}


def _smollm_run(rank, on):
    """3 steps of the reduced float32 smollm-360m, rhd_rsa + int8."""
    from repro_torch import telemetry, tree
    from repro_torch.configs import get_spec
    from repro_torch.core import AggregatorConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainStepConfig, make_train_step
    tracer = telemetry.configure(trace.TelemetryConfig(enabled=on))
    telemetry.METRICS.reset()
    spec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")
    model = build_model(spec)
    opt = adamw(1e-3)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", codec="int8", fusion_threshold_mb=0.25)),
        device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    state = opt.init(params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 256, (STEPS, 2 * P, 17)))
    before = _counters()
    for s in range(STEPS):
        params, state, _ = step(params, state, {"tokens": toks[s, :, :-1],
                                                "labels": toks[s, :, 1:]})
    after = _counters()
    hist = telemetry.METRICS.snapshot()["metrics"].get("train_step_s")
    return {"params": [p.detach().numpy().copy()
                       for p in tree.leaves(params)],
            "fingerprint": extras["aggregator"].last_schedule.fingerprint(),
            "launches": {k: after[k] - before[k] for k in after},
            "timed": type(step).__name__,
            "roots": [s.name for s in tracer.roots],
            "null": tracer.span("x", cat="trace") is trace._NULL_SPAN,
            "train_step_s": None if hist is None
            else hist["values"][""]["count"]}


def _closure_cases():
    """The closure on attached p = 4 and 2 × 2 plans: measured replays
    (gloo; for p = 4 also a cuda_ipc view of the world), the residual
    report, the measured timeline and the fused-vs-unfused replay."""
    from repro_torch.core import AggregatorConfig, GradientAggregator, Group
    from repro_torch.core import plan_cache
    from repro_torch.launch.mesh import make_groups
    from repro_torch.telemetry import closure
    leaves = {"a": torch.zeros(P * 4096), "b": torch.zeros(300),
              "c": torch.zeros(64, 32), "d": torch.zeros(P * 8192)}
    world = Group()
    cases = {
        "p4 rhd+int8": (("data",), {"data": world}, "rhd_rsa", "int8"),
        "p4 rhd+int8 cuda_ipc": (("data",),
                                 {"data": Group(transport="cuda_ipc")},
                                 "rhd_rsa", "int8"),
        "2x2 ring×rhd bf16×int8": (("pod", "data"), make_groups(2, 2),
                                   "ring_rsa×rhd_rsa", "bf16×int8")}
    out = {}
    for label, (axes, groups, strategy, codec) in cases.items():
        agg = GradientAggregator(
            AggregatorConfig(strategy=strategy, codec=codec,
                             fusion_threshold_mb=0.01),
            axes, groups, cache=plan_cache.PlanCache())
        sched = agg.resolve(leaves, tuple(groups[a].size for a in axes))
        measured = closure.measure_schedule(sched, groups, reps=2,
                                            device="cpu")
        rep = closure.closure_report(sched, measured)
        k = rep["calibration"]["k"]
        tl = closure.measured_timeline(sched, measured, k,
                                       50 * sched.predicted_s)
        res = {"schedule": sched.to_json(), "measured": measured,
               "report": rep, "timeline": tl.to_dict()}
        if "cuda_ipc" not in label:
            fr = closure.measure_fused_replay(sched, groups, reps=2,
                                              device="cpu")
            res["fused"] = {k_: v for k_, v in fr.items()
                            if k_ != "executor_stats"}
        out[label] = res
    plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
    return out


def _rank_cases(rank, world, np_params, x_all):
    from repro_torch import telemetry
    torch.set_num_threads(1)
    out = {}
    for label, codec, overlap in RUNS:
        tracer = telemetry.configure(trace.TelemetryConfig(enabled=True))
        grads, sched = _snippet(rank, np_params, x_all, codec, overlap)
        out[label] = {"spans": tracer.to_json(), "schedule": sched,
                      "grads": grads,
                      "tids": sorted({ev["tid"] for ev in
                                      tracer.chrome_trace()["traceEvents"]})}
    out["off"] = _smollm_run(rank, False)
    out["on"] = _smollm_run(rank, True)
    telemetry.configure(trace.TelemetryConfig(enabled=False))
    out["closure"] = _closure_cases()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_telemetry")
    np_params, x = _inputs()
    np.savez(d / "inputs.npz", x=x, **np_params)
    script = d / "ref.py"
    script.write_text(_JAX_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("REPRO_TRACE", None)
    env["REPRO_TEST_DEVICES"] = str(P)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(script), os.path.join(ROOT, "tests"),
         str(d / "inputs.npz"), json.dumps(RUNS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = dist.run_ranks(
            _rank_cases, P, (np_params, x),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), threads=1,
            timeout_s=300)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, out[-2000:]
    return json.loads(lines[-1][len("RESULT "):]), port


# ---------------------------------------------------------------------------
# spans against the reference's
# ---------------------------------------------------------------------------

def _norm(rec, drop=HLO_KEYS + SENT_KEYS + ("thread",)):
    return {"name": rec["name"], "cat": rec["cat"],
            "attrs": {k: v for k, v in rec["attrs"].items()
                      if k not in drop},
            "children": [_norm(c, drop) for c in rec["children"]]}


def _spans(rec):
    """Every span of a ``repro/trace/v1`` record, depth-first."""
    return trace.walk(trace.from_json(rec))


@pytest.mark.parametrize("label", ["rhd", "rhd+int8"])
def test_span_forest_equals_the_reference_s(both, label):
    """Every span, name and attribute the reference's, on every rank;
    stage spans drop only ``hlo_kind``/``hlo_bytes``."""
    ref, port = both
    want = [_norm(s) for s in ref[label]["spans"]["spans"]]
    assert [s["name"] for s in want] == ["aggregate.resolve", "aggregate"]
    stage_keys = None
    for r in port:
        got = r[label]["spans"]["spans"]
        assert [_norm(s) for s in got] == want
        assert r[label]["schedule"] == ref[label]["schedule"]
        for s in _spans(r[label]["spans"]):
            assert "thread" not in s.attrs
            if s.name.startswith("stage["):
                stage_keys = set(s.attrs)
    ref_keys = {k for s in _spans(ref[label]["spans"])
                if s.name.startswith("stage[") for k in s.attrs}
    assert stage_keys == ref_keys - set(HLO_KEYS)


@pytest.mark.parametrize("label", ["rhd", "rhd+int8"])
def test_every_ir_path_has_its_span(both, label):
    """Every bucket and stage path of the executed schedule resolves to
    one span with the IR's wire bytes and algorithm; each stage has one
    hop span per RHD hop (p = 4: two halving, two doubling) whose
    payload is the buffer the hop was handed."""
    _, port = both
    for r in port:
        sched = schedule.from_json(r[label]["schedule"])
        spans = {s.attrs["ir_path"]: s
                 for s in _spans(r[label]["spans"])
                 if s.attrs.get("ir_path")}
        stage_sum = 0
        for path, bucket, st in sched.iter_stages():
            sp = spans[path]
            assert sp.attrs["wire_bytes"] == st.wire_bytes
            assert sp.attrs["algorithm"] == st.algorithm
            stage_sum += sp.attrs["wire_bytes"]
            hops = sp.children
            assert [h.attrs["ir_path"] for h in hops] == \
                [f"{path}.hop[{k}]" for k in range(4)]
            rows = 16 * 16 * 4
            assert [h.attrs["payload_bytes"] for h in hops] == \
                [rows // 2, rows // 4, rows // 4, rows // 2]
            if label == "rhd":          # uncoded: the payload itself sent
                assert [h.attrs["sent_bytes"] for h in hops] == \
                    [h.attrs["payload_bytes"] for h in hops]
            assert {h.attrs["codec"] for h in hops} == \
                {sched.codec}
        for bucket in sched.buckets:
            assert bucket.path in spans
        assert stage_sum == sched.total_wire_bytes


def test_overlapped_buckets_trace_on_the_channel_thread(both):
    """The channel's bucket spans are roots opened on its thread, on
    their own Perfetto track, and equal the reference's in-backward
    bucket spans; the gradients are the post-backward ones, bit for
    bit."""
    ref, port = both
    want = {s["attrs"]["ir_path"]: _norm(s)
            for s in ref["rhd overlap"]["spans"]["spans"]
            if s["name"].startswith("bucket[")}
    ref_arm = [s for s in ref["rhd overlap"]["spans"]["spans"]
               if s["name"] == "overlap_params"]
    assert len(want) == 3 and len(ref_arm) == 1
    for r in port:
        rec = r["rhd overlap"]
        roots = rec["spans"]["spans"]
        buckets = [s for s in roots if s["name"].startswith("bucket[")]
        assert {s["attrs"]["ir_path"]: _norm(s) for s in buckets} == want
        for s in trace.walk(trace.from_json(
                {**rec["spans"], "spans": buckets})):
            assert s.attrs["thread"] == "overlap-channel"
        arm = [s for s in roots if s["name"] == "overlap_params"]
        assert [_norm(s) for s in arm] == [_norm(s) for s in ref_arm]
        assert "thread" not in arm[0]["attrs"]
        assert rec["tids"] == [1, 2]
        grads, post = rec["grads"], r["rhd"]["grads"]
        assert sorted(grads) == sorted(post)
        for k in grads:
            assert np.array_equal(grads[k], post[k]), k


def test_disabled_mode_identity(both):
    _, port = both
    for r in port:
        off, on = r["off"], r["on"]
        assert off["fingerprint"] == on["fingerprint"]
        assert off["launches"] == on["launches"]
        assert len(off["params"]) == len(on["params"])
        for a, b in zip(off["params"], on["params"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert off["roots"] == [] and off["null"] is True
        assert off["timed"] == "function" and off["train_step_s"] is None
        assert on["timed"] == "TimedFn" and on["null"] is False
        assert on["roots"].count("train.step") == STEPS
        assert on["train_step_s"] == STEPS
    assert all(np.array_equal(a, b) for a, b in
               zip(port[0]["on"]["params"], port[-1]["on"]["params"]))


CLOSURE_CASES = ["p4 rhd+int8", "p4 rhd+int8 cuda_ipc",
                 "2x2 ring×rhd bf16×int8"]


@pytest.mark.parametrize("case", CLOSURE_CASES)
def test_measure_schedule_covers_every_path(both, case):
    _, port = both
    sched = schedule.from_json(port[0]["closure"][case]["schedule"])
    paths = [p for p, _b, _s in sched.iter_stages()]
    assert len(paths) >= 3
    for r in port:
        res = r["closure"][case]
        assert list(res["measured"]) == paths
        assert all(math.isfinite(v) and v > 0
                   for v in res["measured"].values())
        assert res["measured"] == port[0]["closure"][case]["measured"]
        rep = res["report"]
        assert rep["n_stages"] == len(paths)
        assert [row["path"] for row in rep["stages"]] == paths
        assert rep["calibration"]["k"] > 0
        assert 0.0 <= res["timeline"]["overlap_fraction"] <= 1.0


@pytest.mark.parametrize("case", ["p4 rhd+int8", "2x2 ring×rhd bf16×int8"])
def test_fused_replay_within_the_fused_hop_bound(both, case):
    _, port = both
    for r in port:
        fr = r["closure"][case]["fused"]
        assert fr["unfused_s"] > 0 and fr["fused_s"] > 0
        assert fr["speedup"] == pytest.approx(
            fr["unfused_s"] / fr["fused_s"])
        assert fr["residual_rel"] <= FMA_REL
        assert fr["executor_traces"] == 1


def test_emit_artifact_on_gloo_ranks(tmp_path):
    """``closure.emit_artifact`` on 8 spawned gloo ranks writes the
    canonical cells with every stage measured, and neither package's
    check finds drift in it.  Whether host timings fall in the band
    depends on the machine's load, so the band verdict is not held
    here."""
    from repro.telemetry import closure as jclosure
    from repro_torch.telemetry import closure
    path = str(tmp_path / "telemetry.json")
    art = closure.emit_artifact(path, reps=1, device="cpu")
    assert art["schema"] == closure.TELEMETRY_SCHEMA
    assert [c["name"] for c in art["cells"]] == \
        [c["name"] for c in closure.artifact_cells()]
    assert art["platform"].startswith("8 gloo ranks on the host's CPU (")
    for cell in art["cells"]:
        sched = closure.cell_schedule(cell)
        assert [r["path"] for r in cell["stages"]] == \
            [p for p, _b, _s in sched.iter_stages()]
        assert all(r["measured_s"] > 0 for r in cell["stages"])
    for check in (closure.check_artifact, jclosure.check_artifact):
        problems = check(path)
        assert not [p for p in problems if "band" not in p], problems
