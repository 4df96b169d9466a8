"""``launch/dryrun.py --trace`` on the CPU: the train record's schedule
replayed through the telemetry closure on gloo ranks, spawned once for
the file (~16 s alone, ~14 test-seconds inside the six-worker Tier-1
run).

The reduced smollm-360m at seq 64 on a small 2 (pod) × 4 (data) × 2
(model) mesh: ``plan_step`` resolves and prices the
plan as the dry run does (the model bracket included), and
``_attach_trace`` replays it on 4 spawned gloo ranks (the largest axis),
each stage on a group of its own axis size (the pod and model stages on
ranks 0 and 1, the others idle there):

* ``measured`` carries the reference's ``closure_report`` keys (record,
  calibration and per-stage rows), and its IR paths are exactly the
  schedule's, in order;
* the predicted side is the plan's and deterministic: a second
  ``plan_step`` gives the same stage predictions;
* ``schedule.measured_overlap`` and ``metrics`` are attached and the
  trace file reloads; ``report.telemetry_table`` and the schedule
  table's measured column render it;
* a serving shape records the reference's ``skipped``; a replay that
  cannot fit the card says so before spawning anything;
* ``closure.check_artifact`` passes on the committed
  ``artifacts_torch/telemetry_closure.json`` (gloo ranks on the host's
  CPU); the card's ``cuda_ipc`` record beside it, whose platform names
  the transport, the card and its power limit, fails the band and
  nothing else.
"""
import json
import os

import pytest
import torch

from repro.core import schedule as jschedule
from repro.telemetry import closure as jclosure

from repro_torch import telemetry
from repro_torch.configs import InputShape, get_spec
from repro_torch.experiments import regen
from repro_torch.launch import dryrun, report
from repro_torch.models import build_model
from repro_torch.telemetry import closure

AXES = {"pod": 2, "data": 4, "model": 2}
SHAPE = InputShape("train_small", 64, 8, "train")
PLAN = dict(strategy="rhd_rsa")


def _record():
    spec = get_spec("smollm-360m").reduced()
    rec = {"arch": "smollm-360m", "shape": SHAPE.name, "mesh": "2x4x2",
           "status": "OK"}
    rec.update(dryrun.plan_step(spec, SHAPE, AXES, **PLAN))
    return spec, rec


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    spec, rec = _record()
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    dryrun._attach_trace(rec, spec, SHAPE, AXES, path, device="cpu",
                         verbose=False, **PLAN)
    params = build_model(spec).init(torch.Generator().manual_seed(0),
                                    "meta").tree()
    return rec, dryrun.train_schedule(params, AXES, **PLAN), path


def _reference_keys():
    """The key sets of the reference's ``closure_report``."""
    sched = jschedule.synthetic([1 << 20, 4 << 20], "ring_rsa", (4,),
                                ("data",))
    measured = {p: 1e-3 for p, _b, _s in sched.iter_stages()}
    rep = jclosure.closure_report(sched, measured)
    return set(rep), set(rep["calibration"]), set(rep["stages"][0])


def test_measured_has_the_reference_s_keys(traced):
    rec, _, _ = traced
    top, cal, row = _reference_keys()
    m = rec["measured"]
    assert set(m) == top
    assert set(m["calibration"]) == cal
    assert all(set(r) == row for r in m["stages"])
    assert m["n_stages"] == len(m["stages"])
    assert all(r["measured_s"] > 0 for r in m["stages"]
               if r["op"] != "shard")


def test_ir_paths_are_exactly_the_schedule_s(traced):
    rec, sched, _ = traced
    paths = [p for p, _b, _s in sched.iter_stages()]
    assert [r["path"] for r in rec["measured"]["stages"]] == paths
    ops = {r["op"] for r in rec["measured"]["stages"]}
    assert {"shard", "all_gather"} <= ops           # the model bracket
    axes = {(r["axis"], r["axis_size"]) for r in rec["measured"]["stages"]}
    assert ("pod", 2) in axes and ("data", 4) in axes \
        and ("model", 2) in axes


def test_predicted_side_is_the_plan_s_and_deterministic(traced):
    rec, sched, _ = traced
    want = [float(st.predicted_s) for _p, _b, st in sched.iter_stages()]
    assert [r["predicted_s"] for r in rec["measured"]["stages"]] == want
    _, again = _record()
    assert again["schedule"]["ir"] == rec["schedule"]["ir"]
    assert again["schedule"]["predicted_comm_s"] == \
        rec["schedule"]["predicted_comm_s"]


def test_overlap_metrics_and_trace_file(traced):
    rec, sched, path = traced
    mo = rec["schedule"]["measured_overlap"]
    assert set(mo) == {"overlap_fraction", "hidden_comm_s",
                       "exposed_comm_s", "step_s"}
    assert 0.0 <= mo["overlap_fraction"] <= 1.0
    assert "probe_stage_s" in json.dumps(rec["metrics"])
    with open(path) as f:
        chrome = json.load(f)
    spans = list(telemetry.trace.walk(
        telemetry.trace.from_json(chrome["repro"])))
    assert spans[0].name == "dryrun.trace"
    probes = {s.attrs["ir_path"] for s in spans
              if s.name.startswith("probe:")}
    assert probes <= {p for p, _b, _s in sched.iter_stages()} and probes


def test_report_renders_the_traced_record(traced):
    rec, _, _ = traced
    table = report.telemetry_table([rec])
    assert "smollm-360m" in table and "calibration k" in table
    assert "comm hidden (measured)" in report.schedule_table([rec])


def test_serving_shapes_record_skipped(tmp_path):
    rec = dryrun.run_one("whisper-tiny", "decode_32k", False,
                         verbose=False, trace_path=str(tmp_path / "t.json"),
                         device="cpu")
    assert rec["status"] == "OK"
    assert rec["measured"] == {"skipped":
                               "no ReduceSchedule on non-train shapes"}
    assert not (tmp_path / "t.json").exists()


def test_a_replay_too_large_for_the_card_says_so(monkeypatch):
    """gemma-7b's largest stage on 16 ranks of one 80 GB card."""
    spec = get_spec("gemma-7b")
    params = build_model(spec).init(torch.Generator().manual_seed(0),
                                    "meta").tree()
    sched = dryrun.train_schedule(params, dryrun.mesh_axes(False))
    assert dryrun.replay_bytes(sched) * 16 > 80e9
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (int(79e9), int(80e9)))
    with pytest.raises(ValueError, match="does not fit"):
        dryrun.trace_schedule(sched, device="cuda")


def test_committed_closure_artifacts_check():
    """The committed artifact (gloo ranks on the host's CPU) passes
    ``--check``; the same cells on ``cuda_ipc`` ranks sharing the card,
    kept beside it, fail only the band: their predicted side is the
    current cost model's."""
    assert closure.check_artifact(regen.TELEMETRY_ARTIFACT) == []
    assert closure.main(["--check", regen.TELEMETRY_ARTIFACT]) == 0
    with open(regen.TELEMETRY_ARTIFACT) as f:
        assert json.load(f)["platform"].startswith(
            f"{closure.ARTIFACT_DEVICES} gloo ranks on the host's CPU (")
    path = os.path.join(os.path.dirname(regen.TELEMETRY_ARTIFACT),
                        "telemetry_closure_card_cuda_ipc.json")
    with open(path) as f:
        platform = json.load(f)["platform"]
    assert platform.startswith(f"{closure.ARTIFACT_DEVICES} cuda_ipc "
                               f"ranks on one NVIDIA")
    assert platform.endswith(" W")
    problems = closure.check_artifact(path)
    assert problems and all("out of band" in p or "all_within_band" in p
                            for p in problems), problems
