"""``repro_torch.analysis`` against ``repro.analysis``.

* Every one of the 157 schedule cells (``experiments/matrix
  .analysis_cells``): the label, ``to_json()`` (full and grouped) and the
  ``verify_summary`` JSON equal the reference's, byte for byte.
* Each SV000–SV009 case of ``tests/test_analysis.py``, doctored the same
  way on both packages' IR, gives the same findings ``(rule_id,
  severity, location, message)``, and a clean schedule none.
* ``wire_check`` gives the reference's dict on the same inputs.
* The import lint: IL001/IL002 on a fixture file, nothing on the tree.
* The CLI: ``--schedules --json`` writes the reference's summary;
  ``--schedule-json`` exits 1 on a doctored record, 0 on a clean one.

No ranks, no card; about 12 s.
"""
import dataclasses
import hashlib
import json
import os
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import __main__ as jcli
from repro.analysis import hlo_lint as jhlo
from repro.analysis import verify as jverify
from repro.core import schedule as jsm
from repro.core import selector as jselector
from repro.experiments import matrix as jmatrix
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import hop_lint, import_lint
from repro_torch.analysis import verify
from repro_torch.core import schedule as sm
from repro_torch.core import selector
from repro_torch.experiments import matrix

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.fixture(scope="module")
def cells():
    return list(jmatrix.analysis_cells()), list(matrix.analysis_cells())


def test_the_157_cells_and_their_labels(cells):
    ref, port = cells
    assert len(port) == 157
    assert [label for label, _ in port] == [label for label, _ in ref]


@pytest.mark.parametrize("i", range(157))
def test_cell_json_and_verify_summary_equal_the_reference_s(cells, i):
    (label, ref), (_, got) = cells[0][i], cells[1][i]
    assert _dump(got.to_json()) == _dump(ref.to_json())
    assert _dump(got.to_json(group=True)) == _dump(ref.to_json(group=True))
    assert _dump(verify.verify_summary(got, context=label)) == \
        _dump(jverify.verify_summary(ref, context=label))


def test_matrix_rows_equal_the_reference_s():
    pts = [pt for pt in matrix.grid() if pt.p in (1, 8, 128)]
    jpts = [pt for pt in jmatrix.grid() if pt.p in (1, 8, 128)]
    assert _dump(matrix.run_matrix(pts)) == _dump(jmatrix.run_matrix(jpts))
    for pt in pts[:8]:
        args = (pt.model, pt.p, pt.design, matrix.PROFILES["paper"])
        jargs = args[:3] + (jmatrix.PROFILES["paper"],)
        assert matrix.throughput(*args) == jmatrix.throughput(*jargs)
        assert matrix.step_timeline(*args).to_dict() == \
            jmatrix.step_timeline(*jargs).to_dict()


# ---------------------------------------------------------------------------
# the SV rules on doctored schedules, both packages
# ---------------------------------------------------------------------------

def _flat(mod, n_buckets=2, p=8, **kw):
    return mod.synthetic([(8 << 20) // (i + 1) for i in range(n_buckets)],
                         "rhd_rsa", (p,), ("data",), **kw)


def _attached(mod, switch_points=(), sel=None):
    sizes = {"a": 1000, "b": 2000, "c": 3000, "d": 50000}
    if mod is jsm:
        tree = {k: jax.ShapeDtypeStruct((n,), jnp.float32)
                for k, n in sizes.items()}
    else:
        tree = {k: torch.empty((n,), device="meta") for k, n in sizes.items()}
    return mod.plan(tree, axis_names=("data",), axis_sizes=(8,),
                    threshold_bytes=16 << 10, selector=sel)


def _coded(mod, strategy="ring_rsa", codec="int8", p=8):
    return mod.synthetic([8 << 20], strategy, (p,), ("data",), codec=codec)


def _composed(mod):
    return mod.synthetic([8 << 20], "ring_rsa×rhd_rsa", (2, 8),
                         ("pod", "data"))


def _bucket(s, i, **kw):
    buckets = list(s.buckets)
    buckets[i] = dataclasses.replace(buckets[i], **kw)
    return dataclasses.replace(s, buckets=tuple(buckets))


def _stage(s, j=0, **kw):
    b = s.buckets[0]
    stages = list(b.stages)
    stages[j] = dataclasses.replace(stages[j], **kw)
    return _bucket(s, 0, stages=tuple(stages))


def _leaky(mod, base):
    @dataclasses.dataclass(frozen=True)
    class LatencyLeaky(mod.ReduceSchedule):
        def fingerprint(self, detached=False):
            blob = (super().fingerprint(detached)
                    + repr(self.predicted_s)).encode()
            return hashlib.sha256(blob).hexdigest()[:16]

    return LatencyLeaky(**{f.name: getattr(base, f.name)
                           for f in dataclasses.fields(base)})


def _first_fused_leaf_bytes(s):
    fused = [b for b in s.buckets if len(b.leaf_indices) > 1]
    return s.plan.leaves[fused[0].leaf_indices[0]].size * 4


# (case, rule that must fire or None for a clean schedule, build(mod))
SV_CASES = {
    "clean flat": (None, lambda m: _flat(m)),
    "clean attached": (None, lambda m: _attached(m)),
    "clean composed": (None, _composed),
    "clean coded fused": (None, lambda m: m.with_fused_hops(
        _coded(m, "rhd_rsa"), True)),
    "SV000 placement": ("SV000", lambda m: dataclasses.replace(
        _flat(m), placement="eager")),
    "SV000 duplicate axes": ("SV000", lambda m: dataclasses.replace(
        _flat(m), axis_names=("data", "data"), axis_sizes=(4, 2))),
    "SV001 stage bytes": ("SV001", lambda m: _stage(
        _flat(m), wire_bytes=_flat(m).buckets[0].stages[0].wire_bytes + 64)),
    "SV001 strategy": ("SV001", lambda m: _bucket(_flat(m), 0,
                                                  strategy="ring_rsa")),
    "SV002 unterminated": ("SV002", lambda m: _bucket(
        _composed(m), 0, stages=_composed(m).buckets[0].stages[:-1])),
    "SV002 reordered": ("SV002", lambda m: _bucket(
        _composed(m), 0, stages=_composed(m).buckets[0].stages[::-1])),
    "SV002 covered twice": ("SV002", lambda m: _bucket(
        _flat(m, 1), 0, stages=_flat(m, 1).buckets[0].stages * 2)),
    "SV003 gap": ("SV003", lambda m: _bucket(
        _attached(m), 0,
        leaf_indices=_attached(m).buckets[0].leaf_indices[:-1])),
    "SV003 overlap": ("SV003", lambda m: _bucket(
        _attached(m), 1, leaf_indices=_attached(m).buckets[1].leaf_indices
        + _attached(m).buckets[0].leaf_indices[:1])),
    "SV004 not a permutation": ("SV004", lambda m: _bucket(
        _bucket(_flat(m), 0, readiness_rank=0), 1, readiness_rank=0)),
    "SV004 non-monotone": ("SV004", lambda m: _bucket(
        _bucket(_attached(m), 0,
                readiness_rank=_attached(m).buckets[1].readiness_rank), 1,
        readiness_rank=_attached(m).buckets[0].readiness_rank)),
    "SV005 straddle": ("SV005", lambda m: dataclasses.replace(
        _attached(m),
        switch_points=(_first_fused_leaf_bytes(_attached(m)) + 1,))),
    "SV005 aligned auto": (None, lambda m: _attached(
        m, sel=(jselector if m is jsm else selector).AnalyticSelector())),
    "SV006 int8 wire": ("SV006", lambda m: dataclasses.replace(
        _flat(m), wire_dtype="int8")),
    "SV007 leaky fingerprint": ("SV007", lambda m: _leaky(m, _flat(m))),
    "SV008 unknown codec": ("SV008", lambda m: _stage(_coded(m),
                                                      codec="int4")),
    "SV008 coded bytes": ("SV008", lambda m: _stage(
        _coded(m), wire_bytes=_coded(m).buckets[0].stages[0].wire_bytes
        + 64)),
    "SV008 codec on psum": ("SV008", lambda m: _stage(
        m.synthetic([8 << 20], "psum", (8,), ("data",)), codec="int8")),
    "SV009 fused all_gather": ("SV009", lambda m: _stage(
        _composed(m), 2, fused_hop=True)),
    "SV009 fused psum": ("SV009", lambda m: _stage(
        m.synthetic([8 << 20], "psum", (8,), ("data",)), fused_hop=True)),
    "SV009 fused shard": ("SV009", lambda m: _stage(
        m.synthetic([8 << 20], "rhd_rsa", (4,), ("data",),
                    model_axis="model", model_axis_size=2), 0,
        fused_hop=True)),
}


def _findings(diags):
    return [(d.rule_id, d.severity, d.location, d.message, d.context)
            for d in diags]


@pytest.mark.parametrize("case", list(SV_CASES))
def test_sv_rule_findings_equal_the_reference_s(case):
    rule, build = SV_CASES[case]
    got = verify.verify_schedule(build(sm), context=case)
    want = jverify.verify_schedule(build(jsm), context=case)
    assert _findings(got) == _findings(want)
    fired = {d.rule_id for d in got}
    if rule is None:
        assert not got, [d.render() for d in got]
    else:
        assert rule in fired, (case, fired)


def test_tolerances_equal_the_reference_s():
    for spec in ("bf16", "int8", "fp8_e4m3"):
        for strat in ("ring_rsa", "rhd_rsa"):
            got, want = _coded(sm, strat, spec), _coded(jsm, strat, spec)
            assert verify.codec_tolerance(got) == \
                jverify.codec_tolerance(want)
            assert verify.wire_tolerance(got) == jverify.wire_tolerance(want)
    bad = _stage(_coded(sm), codec="int4")
    assert verify.codec_tolerance(bad) is None
    assert verify.closed_form_wire_bytes("ring_rsa×rhd_rsa", 1 << 20,
                                         (4, 8)) == \
        jverify.closed_form_wire_bytes("ring_rsa×rhd_rsa", 1 << 20, (4, 8))


@pytest.mark.parametrize("charged", [
    {"collective-permute": 3 << 20, "all-reduce": 123},
    {"collective-permute": 1 << 10},
    {}])
def test_wire_check_equals_the_reference_s(charged):
    for build in (lambda m: m.synthetic([1 << 20], "ring_rsa", (4,),
                                        ("data",)),
                  lambda m: m.synthetic([1 << 20, 3 << 20], "psum", (4,),
                                        ("data",)),
                  lambda m: m.synthetic([1 << 20], "ring_rsa×rhd_rsa",
                                        (2, 4), ("pod", "data"),
                                        model_axis="model",
                                        model_axis_size=2)):
        assert hop_lint.wire_check(build(sm), charged) == \
            jhlo.wire_check(build(jsm), charged)


def test_stage_kinds_equal_the_reference_s(cells):
    for (_, ref), (_, got) in zip(*cells):
        assert [(st.hlo_kind, st.hlo_bytes) for _p, _b, st in
                got.iter_stages()] == \
            [(st.hlo_kind, st.hlo_bytes) for _p, _b, st in
             ref.iter_stages()]
        assert got.algorithms() == ref.algorithms()


# ---------------------------------------------------------------------------
# the import lint
# ---------------------------------------------------------------------------

VIOLATIONS = textwrap.dedent("""\
    import jax                                      # IL001
    import jax.numpy as jnp                         # IL001
    from jax import lax                             # IL001
    import repro.core                               # IL002
    from repro.core import schedule                 # IL002
    from repro import analysis                      # IL002
    import repro_torch                              # fine
    from repro_torch.core import schedule as s2     # fine
    from . import sibling                           # fine (relative)
    import jaxtyping                                # fine: not jax

    def f():
        import repro                                # IL002
        return repro
""")


def test_import_lint_flags_violations(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text(VIOLATIONS)
    diags = import_lint.lint_file(str(p), rel="bad.py")
    got = [(d.rule_id, int(d.location.split(":")[1])) for d in diags]
    assert got == [("IL001", 1), ("IL001", 2), ("IL001", 3), ("IL002", 4),
                   ("IL002", 5), ("IL002", 6), ("IL002", 13)], \
        [d.render() for d in diags]
    assert all(d.severity == "error" for d in diags)


def test_import_lint_is_green_on_the_tree():
    diags = import_lint.lint_tree(ROOT)
    assert diags == [], [d.render() for d in diags]
    rels = [rel for _, rel in import_lint.iter_source_files(ROOT)]
    assert "chip_smoke.py" in rels
    assert os.path.join("src", "repro_torch", "core", "dist.py") in rels
    assert os.path.join("examples", "torch_quickstart.py") in rels
    assert os.path.join("examples", "quickstart.py") not in rels
    assert not any(r.startswith("tests") or
                   r.startswith(os.path.join("src", "repro", ""))
                   for r in rels)


def test_import_lint_fails_on_a_root_without_the_port(tmp_path, capsys):
    """A root that is not the repository's gives an error, not a pass
    over no file."""
    (tmp_path / "tools").mkdir()
    (tmp_path / "tools" / "ok.py").write_text("import os\n")
    diags = import_lint.lint_tree(str(tmp_path))
    assert sorted((d.rule_id, d.location) for d in diags) == [
        ("IL000", "chip_smoke.py"),
        ("IL000", os.path.join("src", "repro_torch"))]
    assert cli.main(["--source", "--root", str(tmp_path)]) == 1
    assert "1 source files" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_schedules_json_equals_the_reference_s(tmp_path, capsys):
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    assert cli.main(["--schedules", "--json", str(got), "-q"]) == 0
    assert jcli.main(["--schedules", "--json", str(want), "-q"]) == 0
    assert got.read_text() == want.read_text()
    assert json.loads(got.read_text())["n_cells"] == 157


def test_cli_gate_and_baseline(tmp_path, capsys):
    clean = _flat(sm).to_json()
    doctored = json.loads(json.dumps(clean))
    doctored["buckets"][0]["stages"][0]["wire_bytes"] += 64
    (tmp_path / "clean.json").write_text(json.dumps(clean))
    (tmp_path / "doctored.json").write_text(json.dumps(doctored))
    assert cli.main(["--schedule-json", str(tmp_path / "clean.json")]) == 0
    assert cli.main(["--schedule-json",
                     str(tmp_path / "doctored.json")]) == 1
    assert "SV001" in capsys.readouterr().out
    out = tmp_path / "src.json"
    assert cli.main(["--source", "--check-baseline", "--root", ROOT,
                     "--json", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["schema"] == "repro/analysis/v1" and rec["n_errors"] == 0
    assert rec["n_source_files"] == len(list(
        import_lint.iter_source_files(ROOT)))
    assert hop_lint.load_baseline() == []
