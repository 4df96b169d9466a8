"""The hop lint (``repro_torch.analysis.hop_lint``) on hops that ran.

One spawn of 4 gloo ranks (file rendezvous), telemetry on in the ranks:

* a reduced float32 smollm-360m train step, ``rhd_rsa`` + ``int8`` with
  fused hops (post-backward);
* a MobileNet-v1 train step at image 64, ``rhd_rsa``, ``overlap=True``
  (the buckets reduced inside the backward on the overlap channel),
  whose backward's last gradient is held for a second, so that the
  overlap HL002 asks for does not depend on the host's load.

Each rank returns its trace; here each rank's hop log
(:func:`hop_lint.hop_log`, read from the trace's JSON) is linted against
the executed schedule: both are clean (HL002 checked on the overlapped
run with the backward's end from ``OverlapRecord``), every stage of the
plan has hops in the log, the per-kind bytes pass the reference's
``wire_check``, and every stage of a bucket of several leaves sent
exactly ``exact_sent_bytes``.  Then each of HL001–HL005 fires on a log doctored to
break it: a hop's sent bytes halved; the backward ending before any
bucket's hops; an f32 hop in an int8 stage; a vendor all-reduce inside
the aggregate; a coded payload sent as f32.

About 15 s on 6 cores.
"""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis import ERROR, WARN, hop_lint
from repro_torch.core import dist, schedule

P = 4
IMAGE = 64
HOLD_S = 1.0


def _lm_step():
    from repro_torch.configs import get_spec
    from repro_torch.core import AggregatorConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainStepConfig, make_train_step
    spec = dataclasses.replace(get_spec("smollm-360m").reduced(),
                               dtype="float32")
    model = build_model(spec)
    opt = adamw(1e-3)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(aggregator=AggregatorConfig(
            strategy="rhd_rsa", codec="int8", fusion_threshold_mb=0.25)),
        device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2 * P, 17)))
    step(params, opt.init(params), {"tokens": toks[:, :-1],
                                    "labels": toks[:, 1:]})
    return extras["aggregator"]


def _cnn_step():
    from repro_torch.core import AggregatorConfig
    from repro_torch.data import SyntheticImages
    from repro_torch.models import CnnSpec, build_cnn
    from repro_torch.optim import sgd
    from repro_torch.train import TrainStepConfig, make_train_step
    model = build_cnn(CnnSpec("mobilenet", image_size=IMAGE,
                              dtype="float32"))
    opt = sgd(0.05, momentum=0.0)
    step, extras = make_train_step(
        model, opt, TrainStepConfig(
            aggregator=AggregatorConfig(strategy="rhd_rsa", overlap=True,
                                        fusion_threshold_mb=0.5),
            clip_norm=1e30), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), "cpu").tree()
    batch = SyntheticImages(8 * P, IMAGE).batch_at(0)
    # The backward's last gradient (the images') waits HOLD_S: a slow
    # first layer, inside which the channel has reduced its first
    # buckets however loaded the host is and however far the ranks
    # drift apart.  A channel that waited for the backward would not.
    batch["images"].requires_grad_(True)
    batch["images"].register_hook(lambda g: time.sleep(HOLD_S))
    step(params, opt.init(params), batch)
    return extras["aggregator"]


def _rank(rank, world):
    from repro_torch import telemetry
    from repro_torch.core import plan_cache
    from repro_torch.telemetry import trace
    torch.set_num_threads(1)
    out = {}
    for label, run in (("lm", _lm_step), ("cnn", _cnn_step)):
        tracer = telemetry.configure(trace.TelemetryConfig(enabled=True))
        agg = run()
        rec = {"trace": tracer.to_json(),
               "schedule": agg.last_schedule.to_json()}
        if agg.last_overlap is not None:
            rec["backward_end"] = agg.last_overlap.backward_end
        out[label] = rec
        plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
    telemetry.configure(trace.TelemetryConfig(enabled=False))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = dist.run_ranks(_rank, P, rendezvous_dir=str(
        tmp_path_factory.mktemp("rdv")), threads=1, timeout_s=300)
    out = []
    for r, rec in enumerate(ranks):
        got = {}
        for label, run in rec.items():
            got[label] = {"log": hop_lint.hop_log(run["trace"], rank=r),
                          "sched": schedule.from_json(run["schedule"]),
                          "backward_end": run.get("backward_end")}
        out.append(got)
    return out


def _lint(run, log=None, **kw):
    return hop_lint.lint_hops(run["sched"], run["log"] if log is None
                              else log,
                              backward_end=run["backward_end"], **kw)


@pytest.mark.parametrize("label", ["lm", "cnn"])
def test_executed_hops_lint_clean(runs, label):
    for r, rank in enumerate(runs):
        run = rank[label]
        sched, log = run["sched"], run["log"]
        diags = _lint(run)
        assert [d for d in diags if d.severity == ERROR] == [], \
            [d.render() for d in diags]
        assert hop_lint.unbaselined_warnings(
            diags, hop_lint.load_baseline()) == []
        # not vacuous: every stage that sends has hops in the log, inside
        # the aggregate, and the per-kind bytes cover the IR's
        paths = {p for p, _b, st in sched.iter_stages() if st.hlo_bytes}
        assert paths and paths <= {rec["stage"] for rec in log}
        assert {rec["aggregate"] for rec in log if rec["stage"]} == \
            ({"in_backward"} if label == "cnn" else {"aggregate[0]"})
        wc = hop_lint.wire_check(sched, hop_lint.charged_bytes(log))
        assert wc["consistent"] and wc["predicted_total"] > 0, wc
        if label == "lm":
            assert sched.codec == "int8"
            assert any(st.fused_hop for _p, _b, st in sched.iter_stages())
            assert {rec["dtype"] for rec in log if rec["stage"]} == {"int8"}
        else:
            assert sched.placement == "in_backward"
            before, total = hop_lint.overlap_witness(log,
                                                     run["backward_end"])
            assert 0 < before <= total == sched.n_buckets


def test_hop_log_records_what_the_transport_sent(runs):
    """Uncoded hops send their payload; a coded hop its codec's bytes
    beside one f32 scale per encoded block (RHD's last doubling hop at
    p = 4 joins two chunks)."""
    for rank in runs:
        for rec in rank["cnn"]["log"]:
            if rec["kind"] == "collective-permute" and rec["sent_bytes"]:
                assert rec["parts"] == [["float32", rec["sent_bytes"]]]
        for rec in rank["lm"]["log"]:
            if rec["kind"] == "collective-permute" and rec["sent_bytes"]:
                (dt, n), (sdt, sn) = rec["parts"]
                assert dt == "int8" and n > 0
                assert sdt == "float32" and sn in (4, 8)   # 1 or 2 blocks
                assert rec["sent_bytes"] == n + sn


def test_stages_send_exactly_the_ir_s_bytes_unless_padded(runs):
    """A stage's hops send what ``exact_sent_bytes`` gives (the IR's
    bytes, a scale per encoded block) or, where a single stacked leaf's
    rows are padded to a multiple of p, more; a bucket of several leaves
    is flattened and never padded, so it sends exactly that."""
    for rank in runs:
        for label in ("lm", "cnn"):
            run = rank[label]
            sent = hop_lint.stage_sent_bytes(run["log"])
            exact = 0
            for path, b, st in run["sched"].iter_stages():
                if not st.hlo_bytes:
                    continue
                want = hop_lint.exact_sent_bytes(st)
                assert sent[path] >= want, (label, path, sent[path], want)
                if len(b.leaf_indices) > 1:
                    assert sent[path] == want, (label, path, sent[path],
                                                want)
                    exact += 1
            assert exact, label


def _halve(log, sched):
    """Halve the largest hop of the stage whose hops sent the least
    above its IR bytes (a stacked leaf with fewer layers than ranks is
    padded to a multiple of p rows, and sends that much more)."""
    log = copy.deepcopy(log)
    sent = hop_lint.stage_sent_bytes(log)
    path = min((p for p, _b, st in sched.iter_stages() if st.hlo_bytes),
               key=lambda p: sent[p] / sched_bytes(sched, p))
    rec = max((r for r in log if r["stage"] == path),
              key=lambda r: r["sent_bytes"])
    rec["sent_bytes"] //= 2
    rec["parts"][0][1] //= 2
    return log


def sched_bytes(sched, path):
    return next(st.hlo_bytes for p, _b, st in sched.iter_stages()
                if p == path)


def _f32_hop(log, sched=None):
    log = copy.deepcopy(log)
    rec = next(r for r in log if r["dtype"] == "int8")
    rec["dtype"] = "float32"
    return log


def _psum_inside(log, sched=None):
    log = copy.deepcopy(log)
    log.append({"rank": 0, "ir_path": "bucket[0].stage[0]",
                "stage": "bucket[0].stage[0]", "bucket": "bucket[0]",
                "kind": "all-reduce", "sent_bytes": 4096,
                "dtype": "float32", "parts": [["float32", 4096]],
                "t0": 0.0, "t1": 0.0, "aggregate": "aggregate[0]"})
    return log


def _coded_as_f32(log, sched=None):
    log = copy.deepcopy(log)
    rec = max((r for r in log if r["dtype"] == "int8"),
              key=lambda r: r["sent_bytes"])
    n = rec["parts"][0][1]
    rec["parts"][0] = ["float32", 4 * n]
    rec["dtype"] = "float32"
    rec["sent_bytes"] += 3 * n
    return log


# rule -> (run, doctor(log) or None, backward_end override)
DOCTORED = {
    "HL001": ("lm", _halve, None),
    "HL002": ("cnn", None, "before"),
    "HL003": ("lm", _f32_hop, None),
    "HL004": ("lm", _psum_inside, None),
    "HL005": ("lm", _coded_as_f32, None),
}


@pytest.mark.parametrize("rule", sorted(DOCTORED))
def test_each_rule_fires_on_its_doctored_log(runs, rule):
    label, doctor, end = DOCTORED[rule]
    run = runs[0][label]
    log = doctor(run["log"], run["sched"]) if doctor else run["log"]
    if end == "before":
        run = {**run, "backward_end": min(r["t0"] for r in log) - 1.0}
    diags = _lint(run, log=log)
    hits = [d for d in diags if d.rule_id == rule]
    assert hits, [d.render() for d in diags]
    want = WARN if rule == "HL004" else ERROR
    assert all(d.severity == want for d in hits)
    if rule == "HL001":
        assert hits[0].location.startswith("bucket[")
    if rule == "HL004":
        accepted = [{"rule_id": "HL004", "context": "*"}]
        assert hop_lint.unbaselined_warnings(diags, accepted) == []
        assert hop_lint.unbaselined_warnings(diags, []) == hits


def test_vendor_collective_outside_an_aggregate_is_not_hl004(runs):
    run = runs[0]["lm"]
    log = _psum_inside(run["log"])
    log[-1]["aggregate"] = None
    assert not any(d.rule_id == "HL004" for d in _lint(run, log=log))


def test_fused_budget_counts_a_scale_per_encoded_block():
    sched = schedule.with_fused_hops(schedule.synthetic(
        [1 << 20], "rhd_rsa", (4,), ("data",), codec="int8"), True)
    (st,) = sched.buckets[0].stages
    assert hop_lint.stage_hops(st) == (2, 2, 3)
    assert hop_lint.fused_f32_permute_budget(sched) == (2 + 3) * 4
    # the IR charges a scale per hop (4), the hops send one per block (5)
    assert hop_lint.exact_sent_bytes(st) == st.hlo_bytes + 4
    plain = schedule.synthetic([1 << 20], "ring_rsa", (4,), ("data",))
    assert hop_lint.fused_f32_permute_budget(plain) == \
        plain.buckets[0].stages[0].wire_bytes
