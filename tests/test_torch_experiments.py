"""The port's characterization layer against the reference's, on the
CPU (one process, no ranks; ~32 s alone, ~47 test-seconds inside the
six-worker Tier-1 run).

``repro_torch.experiments`` (matrix on the analytic backend with the
``paper`` and ``v5e`` profiles, claims C1–C10, regen) against
``repro.experiments`` computed fresh in this process — never against the
reference's committed ``BENCH_experiments.json`` / ``EXPERIMENTS.md``:

* ``build_record()``'s sections ``scaling``, ``batch``, ``micro``,
  ``claims`` and ``meta`` equal the reference's after a JSON round trip;
* the reference's claim-wall tests, ported: every claim PASSes, keys are
  unique with anchors and real bands, a v5e link 8× slower and an MFU 4×
  higher each push a claim out of its band;
* ``regen``: write → ``--check`` clean, an edited file or value is
  found, unreadable files are, the CLI, ``run_lines``; the committed
  ``artifacts_torch/`` files are current;
* the matrix semantics the claims stand on (grid, query/value, the
  no-gRPC ordering, p = 1, the PS design's per-variable buckets, the
  measured backend's injected table through the same timeline).
"""
import dataclasses
import json

import pytest

from repro.experiments import claims as jclaims
from repro.experiments import matrix as jmx
from repro.experiments import regen as jregen

from repro_torch.core import cost_model as cm
from repro_torch.core import hw
from repro_torch.experiments import claims as claims_mod
from repro_torch.experiments import matrix as mx
from repro_torch.experiments import regen

SECTIONS = ("scaling", "batch", "micro", "claims", "meta")


def _via_json(rec):
    return json.loads(json.dumps(rec))


@pytest.fixture(scope="module")
def records():
    """(the port's record, the reference's), each built once."""
    return _via_json(regen.build_record()), _via_json(jregen.build_record())


@pytest.mark.parametrize("section", SECTIONS)
def test_record_sections_equal_reference(records, section):
    ours, ref = records
    assert ours[section] == ref[section]


def test_schema_and_profiles(records):
    ours, _ = records
    assert ours["schema"] == regen.SCHEMA == "repro_torch/experiments/v1"
    assert sorted(mx.PROFILES) == sorted(jmx.PROFILES) == ["paper", "v5e"]
    for name, prof in mx.PROFILES.items():
        ref = jmx.PROFILES[name]
        assert (prof.name, prof.flops, prof.mfu, prof.sync_s,
                prof.overhead_s) == (ref.name, ref.flops, ref.mfu,
                                     ref.sync_s, ref.overhead_s)
        for link in ("link", "grpc"):
            got, want = getattr(prof, link), getattr(ref, link)
            assert (got.alpha_s, got.bandwidth) == (want.alpha_s,
                                                    want.bandwidth)
    assert hw.V5E.peak_bf16_flops == 197e12
    assert (cm.GRPC.alpha_s, cm.GRPC.bandwidth) == (100e-6, 10e9)


# ---------------------------------------------------------------------------
# the wall
# ---------------------------------------------------------------------------

def test_every_claim_passes_with_the_reference_s_values(records):
    ours, _ = records
    failing = [(r["key"], r["value"], r["lo"], r["hi"])
               for r in ours["claims"] if r["status"] != "PASS"]
    assert not failing, f"claims outside their bands: {failing}"
    assert [r["key"] for r in ours["claims"]] == \
        [c.key for c in jclaims.CLAIMS]
    assert len(ours["claims"]) == 10


def test_every_claim_has_anchor_band_and_unique_key():
    keys = set()
    for c in claims_mod.CLAIMS:
        assert c.key not in keys, f"duplicate claim key {c.key}"
        keys.add(c.key)
        assert c.anchor.strip(), c.key
        assert c.paper_value.strip(), c.key
        assert c.lo < c.hi, (c.key, c.lo, c.hi)
        assert c.units in ("x", "fraction"), c.key
    assert any(k.startswith("C1_") for k in keys)
    assert any("v5e" in k for k in keys)
    dup = claims_mod.CLAIMS + claims_mod.CLAIMS[:1]
    with pytest.raises(ValueError, match="duplicate"):
        claims_mod.evaluate(dup)


def test_bands_are_sensitive_to_profile_constants(monkeypatch):
    """An 8× slower v5e link pushes a v5e claim out of its band."""
    prof = mx.PROFILES["v5e"]
    slow = dataclasses.replace(
        prof, link=cm.LinkParams(prof.link.alpha_s,
                                 prof.link.bandwidth / 8.0))
    monkeypatch.setitem(mx.PROFILES, "v5e", slow)
    failing = [r["key"] for r in claims_mod.evaluate()
               if r["status"] == "FAIL"]
    assert any("v5e" in k for k in failing), failing


def test_bands_are_sensitive_to_compute_constants(monkeypatch):
    """A 4× MFU on the paper profile moves the compute/comm balance
    every scaling claim rests on."""
    prof = mx.PROFILES["paper"]
    monkeypatch.setitem(mx.PROFILES, "paper",
                        dataclasses.replace(prof, mfu=prof.mfu * 4))
    assert any(r["status"] == "FAIL" for r in claims_mod.evaluate())


# ---------------------------------------------------------------------------
# regen
# ---------------------------------------------------------------------------

def test_committed_artifacts_are_current():
    problems = regen.check()
    assert not problems, "\n".join(problems)
    with open(regen.JSON_ARTIFACT) as f:
        rec = json.load(f)
    assert rec["schema"] == regen.SCHEMA
    assert len(rec["scaling"]) == 2 * len(mx.DESIGNS) * len(mx.MODELS) \
        * len(mx.WORKERS)


def test_regen_check_detects_drift(tmp_path):
    md = tmp_path / "EXPERIMENTS.md"
    js = tmp_path / "experiments.json"
    regen.write(str(md), str(js))
    assert regen.check(str(md), str(js)) == []
    assert "python -m repro_torch.experiments.regen" in md.read_text()
    md.write_text(md.read_text() + "\ntrailing edit\n")
    assert any("EXPERIMENTS.md" in p for p in regen.check(str(md), str(js)))
    rec = json.loads(js.read_text())
    rec["claims"][0]["value"] += 1.0
    js.write_text(json.dumps(rec))
    assert any("experiments.json" in p
               for p in regen.check(str(md), str(js)))
    problems = regen.check(str(tmp_path / "nope.md"),
                           str(tmp_path / "nope.json"))
    assert len(problems) == 2
    problems = regen.check(str(md), str(js),
                           str(tmp_path / "no_closure.json"))
    assert any("no_closure.json missing" in p for p in problems)


def test_regen_cli_check_and_rewrite(tmp_path, capsys):
    md = tmp_path / "out" / "EXPERIMENTS.md"
    js = tmp_path / "out" / "experiments.json"
    assert regen.main(["--out-md", str(md), "--out-json", str(js)]) == 0
    assert md.exists() and js.exists()
    assert regen.main(["--check", "--out-md", str(md),
                       "--out-json", str(js)]) == 0
    md.write_text("stale")
    assert regen.main(["--check", "--out-md", str(md),
                       "--out-json", str(js)]) == 1
    out = capsys.readouterr().out
    assert "DRIFT" in out and "repro_torch.experiments.regen" in out


def test_regen_run_lines_one_per_claim():
    lines = regen.run_lines()
    assert lines == jregen.run_lines()
    assert len(lines) == len(claims_mod.CLAIMS)
    assert all(line.startswith("claims.C") and "band=" in line
               for line in lines)


# ---------------------------------------------------------------------------
# the matrix semantics the claims stand on
# ---------------------------------------------------------------------------

def test_grid_is_the_declared_cross_product():
    pts = mx.grid()
    assert len(pts) == len(mx.DESIGNS) * len(mx.MODELS) * len(mx.WORKERS)
    assert len(set(pts)) == len(pts)
    with pytest.raises(ValueError, match="design"):
        mx.ExperimentPoint("carrier_pigeon", "resnet50", 4).validate()
    with pytest.raises(ValueError, match="model"):
        mx.ExperimentPoint("gRPC_PS", "alexnet", 4).validate()


def test_query_and_value():
    rows = mx.run_matrix(mx.grid(models=("resnet50",), workers=(1, 8)),
                         profile="paper")
    sub = mx.query(rows, design="gRPC_PS", p=8)
    assert len(sub) == 1 and sub[0]["model"] == "resnet50"
    assert mx.value(rows, "images_per_s", design="gRPC_PS", p=8) == \
        sub[0]["images_per_s"]
    with pytest.raises(ValueError, match="matched"):
        mx.value(rows, "images_per_s", design="gRPC_PS")
    with pytest.raises(ValueError, match="matched"):
        mx.value(rows, "images_per_s", p=999)


def test_model_backend_ordering_no_grpc_beats_ps():
    """Every no-gRPC design out-throughputs the gRPC PS at every p ≥ 4
    (at p = 2 the PS pattern is a 2-way exchange: a modelling tie)."""
    rows = mx.run_matrix(mx.grid(models=("resnet50", "mobilenet")),
                         profile="paper")
    for model in ("resnet50", "mobilenet"):
        for p in mx.WORKERS:
            if p < 4:
                continue
            ps = mx.value(rows, "images_per_s", model=model, p=p,
                          design="gRPC_PS")
            for design in ("Baidu_ring", "Horovod_NCCL2",
                           "Horovod_MPI_Opt"):
                assert mx.value(rows, "images_per_s", model=model, p=p,
                                design=design) > ps, (model, p, design)


def test_efficiency_normalization_and_p1():
    for r in mx.run_matrix(mx.grid(models=("resnet50",), workers=(1,))):
        assert r["efficiency"] == pytest.approx(1.0)
        assert r["comm_s"] == 0.0


def test_ps_design_reduces_per_variable():
    row_ps = mx.run_point(mx.ExperimentPoint("gRPC_PS", "resnet50", 8))
    row_opt = mx.run_point(mx.ExperimentPoint("Horovod_MPI_Opt",
                                              "resnet50", 8))
    assert row_ps["n_buckets"] == mx.MODEL_VARIABLES["resnet50"]
    assert row_opt["n_buckets"] < row_ps["n_buckets"]


@pytest.mark.parametrize("model", ["resnet50", "mobilenet"])
def test_bucket_sizes_equal_reference(model):
    for design in mx.DESIGNS:
        assert mx.bucket_sizes(model, design) == \
            jmx.bucket_sizes(model, design)
