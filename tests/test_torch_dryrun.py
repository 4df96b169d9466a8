"""The planning tools against the reference's: ``configs/base.py``,
``launch/roofline.py``, ``launch/dryrun.py``, ``launch/report.py`` and
``launch/sweep.py``.

* ``configs/base.py`` field by field for every arch × shape: the shapes,
  the ``long_500k`` policy and SKIP reasons, ``spec_for_shape``, and the
  ``input_specs`` meta tensors' shapes and dtypes against the
  reference's ``ShapeDtypeStruct`` s, decode caches included.
* ``model_flops`` and ``active_params`` for every arch (× shape), on
  each package's own parameter count (which must agree).
* The dry run's ``ir`` equals the reference's own resolution on
  ``jax.eval_shape`` parameters (its ``_static_verify`` path, bracketed
  on the model axis as its ``_attach_trace`` path does) for gemma-7b
  and deepseek-v2-lite-16b on 16x16 and 2x16x16; the records verify
  clean, name the card, and SKIP/FAIL as the reference's would.
* The counts' extrapolation (``roofline.count_step``) equals a direct
  count on meta for a reduced spec of every family.
* ``report.py`` of both packages renders the same records identically;
  ``sweep.py`` runs one pair as a subprocess.

No card; about 30 s.
"""
import dataclasses
import json
import os
import types

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import AggregatorConfig as JAggregatorConfig
from repro.core import GradientAggregator as JGradientAggregator
from repro.core import manual as jmanual
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.models import build_model as jbuild_model
from repro.models import param_groups as jparam_groups
from repro_torch import configs, tree
from repro_torch.configs import base
from repro_torch.core import hw
from repro_torch.launch import dryrun, report, roofline, sweep

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = configs.list_archs()
SHAPES = list(base.SHAPES)


def _fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def test_shapes_and_constants_equal_the_reference_s():
    assert configs.list_archs() == jconfigs.list_archs()
    assert {k: _fields(v) for k, v in base.SHAPES.items()} == \
        {k: _fields(v) for k, v in jbase.SHAPES.items()}
    assert base.LONG_CONTEXT_WINDOW == jbase.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_and_shape_specs_equal_the_reference_s(arch):
    spec, jspec = configs.get_spec(arch), jconfigs.get_spec(arch)
    assert base.long500k_policy(spec) == jbase.long500k_policy(jspec)
    for shape in SHAPES:
        assert base.shape_supported(spec, shape) == \
            jbase.shape_supported(jspec, shape)
        assert _fields(base.spec_for_shape(spec, shape)) == \
            _fields(jbase.spec_for_shape(jspec, shape))


def _flat(x):
    if isinstance(x, dict):
        return {f"{k}/{p}" if p else k: v for k in x
                for p, v in _flat(x[k]).items()}
    return {"": x}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference_s(arch):
    spec, jspec = configs.get_spec(arch), jconfigs.get_spec(arch)
    for shape in SHAPES:
        if not base.shape_supported(spec, shape)[0]:
            continue
        got = _flat(base.input_specs(spec, shape))
        want = _flat(jbase.input_specs(jspec, shape))
        assert sorted(got) == sorted(want), (shape, sorted(got))
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
                (tuple(want[k].shape), str(want[k].dtype)), (shape, k)


@pytest.fixture(scope="module")
def n_params():
    out = {}
    for arch in ARCHS:
        spec = configs.get_spec(arch)
        jspec = jconfigs.get_spec(arch)
        from repro_torch.models import build_model
        params = build_model(spec).init(torch.Generator().manual_seed(0),
                                        "meta").tree()
        jparams = jax.eval_shape(jbuild_model(jspec).init,
                                 jax.random.PRNGKey(0))
        out[arch] = (sum(p.numel() for p in tree.leaves(params)),
                     sum(int(p.size) for p in
                         jax.tree_util.tree_leaves(jparams)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference_s(arch,
                                                             n_params):
    spec, jspec = configs.get_spec(arch), jconfigs.get_spec(arch)
    got_n, want_n = n_params[arch]
    assert got_n == want_n
    assert roofline.active_params(spec) == jroofline.active_params(jspec)
    for shape in SHAPES:
        assert roofline.model_flops(spec, base.SHAPES[shape], float(got_n)) \
            == jroofline.model_flops(jspec, jbase.SHAPES[shape],
                                     float(want_n))


# ---------------------------------------------------------------------------
# the dry run's IR against the reference's resolution
# ---------------------------------------------------------------------------

def _reference_ir(arch, multi_pod):
    """The reference's plan for the train step on its production mesh,
    resolved without lowering: ``eval_shape`` parameters, the model axis
    bracketed on shard-shaped structs (``model_shard_specs`` reads only
    the mesh's shape)."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    mesh = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))
    spec = jbase.spec_for_shape(jconfigs.get_spec(arch), "train_4k")
    params = jax.eval_shape(jbuild_model(spec).init, jax.random.PRNGKey(0))
    dp_axes = names[:-1]
    agg = JGradientAggregator(
        JAggregatorConfig(strategy="rhd_rsa", fusion_threshold_mb=4.0,
                          sharding_aware=True), dp_axes, model_axis="model")
    mspecs = jmanual.model_shard_specs(params, mesh, axis="model")
    struct = jmanual.shard_param_structs(params, mspecs, 16)
    sched = agg.resolve(struct, sizes[:-1], groups=jparam_groups(struct),
                        model_axis_size=16)
    return sched.to_json(group=True)


@pytest.fixture(scope="module")
def records():
    return {(arch, mp): dryrun.run_one(arch, "train_4k", mp, verbose=False)
            for arch in ("gemma-7b", "deepseek-v2-lite-16b")
            for mp in (False, True)}


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_record_ir_equals_the_reference_resolution(records, arch,
                                                         multi_pod):
    rec = records[(arch, multi_pod)]
    assert rec["status"] == "OK", rec.get("error")
    assert rec["verified_static"] is True
    assert rec["analysis"]["n_errors"] == 0
    assert rec["schedule"]["verify"]["n_errors"] == 0
    assert json.dumps(rec["schedule"]["ir"], sort_keys=True) == \
        json.dumps(_reference_ir(arch, multi_pod), sort_keys=True)
    assert rec["roofline"]["chip"] == hw.H100_SXM.name
    assert rec["roofline"]["chips"] == (512 if multi_pod else 256)
    ir = rec["schedule"]["ir"]
    assert rec["roofline"]["collective_bytes"] == ir["total_wire_bytes"]
    mem = rec["memory_estimate"]
    assert mem["exact_bytes"] == sum(mem["exact"].values())
    assert mem["exact"]["optimizer"] == 2 * mem["exact"]["params"]
    assert rec["rows_per_rank"] == (8 if multi_pod else 16)


def test_memory_exact_part_is_the_arithmetic():
    spec = configs.get_spec("gemma-7b")
    counts = roofline.StepCounts(0.0, 0.0, 0.0, 0.0)
    one = dryrun.memory_estimate(spec, "train", 2, 4096, counts=counts)
    assert one["exact"]["params"] == 4 * 8_537_680_896
    assert one["exact"]["inputs"] == 2 * 2 * 4096 * 4
    sharded = dryrun.memory_estimate(spec, "train", 2, 4096, m=16,
                                     counts=counts)
    assert sharded["exact"]["params"] < one["exact"]["params"] // 8
    assert sharded["gathered_params_bytes"] == \
        one["exact"]["params"] - sharded["exact"]["params"]
    serve = dryrun.memory_estimate(spec, "decode", 8, 32768,
                                   counts=counts)
    # k and v per layer, and the position (one int32)
    assert serve["exact"]["cache"] == 28 * 2 * 8 * 32768 * 16 * 256 * 2 + 4


def test_skip_and_fail_records():
    rec = dryrun.run_one("smollm-360m", "long_500k", False, verbose=False)
    assert rec["status"] == "SKIP"
    assert rec["reason"] == jbase.shape_supported(
        jconfigs.get_spec("smollm-360m"), "long_500k")[1]
    # seq_parallel plans as the full-manual step does: the port's
    # bracketed schedule (the reference's legacy step plans without the
    # model bracket, which the port does not lower).
    rec = dryrun.run_one("smollm-360m", "train_4k", False, verbose=False,
                         spec_overrides={"seq_parallel": True})
    plain = dryrun.run_one("smollm-360m", "train_4k", False, verbose=False)
    assert rec["status"] == plain["status"] == "OK"
    assert rec["schedule"] == plain["schedule"]
    assert "ag@model" in json.dumps(rec["schedule"])
    rec = dryrun.run_one("whisper-tiny", "decode_32k", True, verbose=False)
    assert rec["status"] == "OK" and "schedule" not in rec
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


# ---------------------------------------------------------------------------
# the counts: extrapolated = counted directly
# ---------------------------------------------------------------------------

COUNT_CASES = {
    "dense flash": ("smollm-360m", dict(num_layers=3), "train", 3, 4096),
    "dense one row": ("smollm-360m", dict(num_layers=3), "train", 1, 512),
    "moe+mla prefix": ("deepseek-v2-lite-16b", dict(
        num_layers=4, d_model=256, moe_d_ff=64, num_experts=8,
        vocab_size=1000, num_heads=4), "train", 2, 256),
    "hybrid": ("zamba2-1.2b", dict(
        num_layers=4, attn_every=2, d_model=256, vocab_size=1000,
        num_heads=4, num_kv_heads=4, d_ff=512, attn_full_seq_max=1024),
        "train", 2, 1280),
    "xlstm": ("xlstm-350m", dict(num_layers=4, slstm_every=2, d_model=128,
                                 vocab_size=500, num_heads=4,
                                 num_kv_heads=4), "train", 2, 6),
    "audio prefill": ("whisper-tiny", dict(num_layers=3, encoder_layers=2),
                      "prefill", 2, 3000),
    "vlm prefill": ("phi-3-vision-4.2b", dict(
        num_layers=3, d_model=256, vocab_size=1000, num_heads=4,
        num_kv_heads=4, d_ff=512), "prefill", 2, 300),
    "decode": ("gemma-7b", dict(num_layers=3, d_model=256, vocab_size=1000,
                                num_heads=2, num_kv_heads=2, d_ff=512),
               "decode", 3, 5000),
}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_extrapolated_counts_equal_a_direct_count(case):
    arch, over, kind, rows, seq = COUNT_CASES[case]
    spec = dataclasses.replace(configs.get_spec(arch), **over)
    got = roofline.count_step(spec, kind, rows, seq)
    want = roofline.probe(dataclasses.replace(spec, attn_chunk=seq), kind,
                          rows, seq)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert want.flops > 0


@pytest.mark.parametrize("case", ["dense flash", "xlstm", "audio prefill",
                                  "decode"])
def test_probe_flops_are_flop_counter_mode_s(case):
    """One pass counts the flops ``FlopCounterMode`` counts (its
    formulas) and the bytes beside them."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import build_model
    arch, over, kind, rows, seq = COUNT_CASES[case]
    spec = dataclasses.replace(configs.get_spec(arch), **over,
                               attn_chunk=seq)
    got = roofline.probe(spec, kind, rows, seq)
    model = build_model(spec)
    params = model.init(torch.Generator().manual_seed(0), "meta").tree()
    batch = roofline._inputs(spec, kind, rows, seq)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            for p in tree.leaves(params):
                p.requires_grad_(True)
            model.loss(params, batch)[0].backward()
        elif kind == "prefill":
            with torch.no_grad():
                model.prefill(params, batch, max_seq=seq)
        else:
            with torch.no_grad():
                model.decode_step(params, model.init_cache(
                    rows, seq, device="meta"), batch["tokens"])
    assert got.flops == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# report and sweep
# ---------------------------------------------------------------------------

def test_report_renders_the_reference_s_markdown(records):
    recs = list(records.values()) + [
        dryrun.run_one("smollm-360m", "long_500k", False, verbose=False),
        dryrun.run_one("whisper-tiny", "decode_32k", False, verbose=False),
        {"arch": "smollm-360m", "shape": "prefill_32k", "mesh": "16x16",
         "status": "FAIL", "error": "x"}]
    recs = json.loads(json.dumps(recs))
    for mesh in ("16x16", "2x16x16"):
        assert report.dryrun_matrix(recs, mesh) == \
            jreport.dryrun_matrix(recs, mesh)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.schedule_table(recs) == jreport.schedule_table(recs)
    assert report.telemetry_table(recs) == jreport.telemetry_table(recs)
    assert report.skips(recs) == jreport.skips(recs)
    assert "OK" in report.dryrun_matrix(recs, "16x16")


def test_sweep_runs_one_pair_in_a_subprocess(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.path.join(ROOT, "src"))
    rec = sweep.run_pair(str(tmp_path), "whisper-tiny", "decode_32k", False,
                         timeout=240)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["mesh"] == "16x16" and rec["wall_s"] > 0
    path = sweep.pair_path(str(tmp_path), "whisper-tiny", "decode_32k",
                           "16x16", "rhd_rsa")
    assert json.load(open(path))["roofline"]["chip"] == hw.H100_SXM.name
    # a second call reads the record back without running again
    again = sweep.run_pair(str(tmp_path), "whisper-tiny", "decode_32k",
                           False)
    assert again["roofline"] == rec["roofline"]


