"""Regenerate the port's characterization artifacts.

    PYTHONPATH=src python -m repro_torch.experiments.regen            # rewrite
    PYTHONPATH=src python -m repro_torch.experiments.regen --check    # gate

Counterpart of ``repro/experiments/regen.py``.  Re-runs the experiment
matrix (matrix.py) on the cost-model backend, evaluates the claims
registry (claims.py), and emits the port's own files, never the
reference's:

``artifacts_torch/EXPERIMENTS.md``    table analogues of the paper's
                                      Figs. 2-12 with a per-claim
                                      PASS/FAIL wall;
``artifacts_torch/experiments.json``  the schema-versioned record (full
                                      matrix rows + claim results).

Everything here is analytic and deterministic, and its sections equal
the reference's ``build_record()``: drift between the committed files
and a fresh regeneration means the model changed without refreshing the
characterization — ``--check`` (and the currency test in
``tests/test_torch_experiments.py``) fails exactly then.  ``--check``
also checks the port's measured closure artifact
(``artifacts_torch/telemetry_closure.json``).  The reference's
``check_allreduce_artifact`` checks the table that
``benchmarks/allreduce_micro.py --emit-table`` writes; that script is
not ported yet, so neither is its check.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..core import cost_model as cm
from . import claims as claims_mod
from . import matrix as mx

SCHEMA = "repro_torch/experiments/v1"

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                     "..", "..", ".."))
ARTIFACT_DIR = os.path.join(_ROOT, "artifacts_torch")
MD_ARTIFACT = os.path.join(ARTIFACT_DIR, "EXPERIMENTS.md")
JSON_ARTIFACT = os.path.join(ARTIFACT_DIR, "experiments.json")
TELEMETRY_ARTIFACT = os.path.join(ARTIFACT_DIR, "telemetry_closure.json")

MICRO_SIZES = (8, 1024, 64 * 1024, 1 << 20, 16 << 20, 256 << 20)
MICRO_P = 16
BATCH_WORKERS = (1, 8, 64)


def micro_rows() -> list[dict]:
    """Figs. 4/6 analogue: per-design allreduce latency vs message size
    at p=16, on the paper and v5e link constants."""
    rows = []
    for profile in ("paper", "v5e"):
        prof = mx.PROFILES[profile]
        fns = {d: mx.design_latency_fn(d, MICRO_P, prof)
               for d in mx.DESIGNS}
        for n in MICRO_SIZES:
            lat = {d: fns[d](n) for d in mx.DESIGNS}
            rows.append({
                "profile": profile, "p": MICRO_P, "bytes": n,
                "latency_us": {d: lat[d] * 1e6 for d in mx.DESIGNS},
                "opt_vs_default": lat["Horovod_MPI"]
                / lat["Horovod_MPI_Opt"],
                "opt_vs_vendor": lat["Horovod_NCCL2"]
                / lat["Horovod_MPI_Opt"],
            })
    return rows


def batch_points() -> list[mx.ExperimentPoint]:
    """Fig. 2 analogue: the per-device-batch axis of the matrix."""
    return mx.grid(designs=("Horovod_MPI_Opt", "gRPC_PS"),
                   models=("resnet50", "mobilenet"),
                   workers=BATCH_WORKERS, batches=mx.BATCHES)


def build_record() -> dict:
    ctx = claims_mod.Ctx()
    scaling = ctx.rows("paper") + ctx.rows("v5e")
    batch = [r for profile in ("paper", "v5e")
             for r in mx.run_matrix(batch_points(), profile=profile)]
    return {
        "schema": SCHEMA,
        "scaling": scaling,
        "batch": batch,
        "micro": micro_rows(),
        "claims": claims_mod.evaluate(ctx=ctx),
        "meta": {
            "backend": "model",
            "designs": list(mx.DESIGNS),
            "models": list(mx.MODELS),
            "workers": list(mx.WORKERS),
            "batches": list(mx.BATCHES),
            "batch_workers": list(BATCH_WORKERS),
            "micro_sizes": list(MICRO_SIZES),
            "micro_p": MICRO_P,
            "profiles": sorted(mx.PROFILES),
            "fusion_bytes": mx.FUSION_BYTES,
            "model_variables": dict(mx.MODEL_VARIABLES),
            "gamma_s_per_byte": cm.GAMMA_S_PER_BYTE,
        },
    }


# ---------------------------------------------------------------------------
# EXPERIMENTS.md rendering
# ---------------------------------------------------------------------------

def _fmt_us(us: float) -> str:
    if us >= 1e5:
        return f"{us / 1e3:.1f} ms"
    return f"{us:.1f} µs"


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n >> 20} MiB"
    if n >= 1024:
        return f"{n >> 10} KiB"
    return f"{n} B"


def _claims_table(claim_rows: list[dict]) -> list[str]:
    out = ["| claim | paper (anchor) | ours | band | status |",
           "|---|---|---|---|---|"]
    for c in claim_rows:
        band = f"[{c['lo']:g}, {c['hi']:g}]"
        mark = "**FAIL**" if c["status"] == "FAIL" else "PASS"
        out.append(
            f"| `{c['key']}` — {c['title']} | {c['paper_value']} "
            f"({c['anchor']}) | {c['value']:.3f} {c['units']} | {band} | "
            f"{mark} |")
    return out


def _micro_table(rows: list[dict], profile: str) -> list[str]:
    out = [f"**{profile} link, p={MICRO_P}** — latency per design, plus "
           "MPI_Opt speedups:",
           "",
           "| message | " + " | ".join(mx.DESIGNS)
           + " | Opt vs default | Opt vs NCCL2 |",
           "|---|" + "---|" * (len(mx.DESIGNS) + 2)]
    for r in rows:
        if r["profile"] != profile:
            continue
        cells = [_fmt_us(r["latency_us"][d]) for d in mx.DESIGNS]
        out.append(f"| {_fmt_bytes(r['bytes'])} | " + " | ".join(cells)
                   + f" | {r['opt_vs_default']:.2f}x"
                   f" | {r['opt_vs_vendor']:.2f}x |")
    out.append("")
    return out


def _scaling_table(rows: list[dict], profile: str,
                   model: str) -> list[str]:
    out = [f"**{model} × {profile}** — images/sec (batch/device "
           f"{mx.BATCH_PER_DEV}); efficiency and hidden-comm fraction "
           "for the paper's design:",
           "",
           "| p | " + " | ".join(mx.DESIGNS)
           + " | MPI_Opt eff | MPI_Opt comm hidden |",
           "|---|" + "---|" * (len(mx.DESIGNS) + 2)]
    sel = mx.query(rows, profile=profile, model=model,
                   batch_per_dev=mx.BATCH_PER_DEV)
    for p in mx.WORKERS:
        cells = []
        for d in mx.DESIGNS:
            r = mx.query(sel, p=p, design=d)
            cells.append(f"{r[0]['images_per_s']:.0f}" if r else "—")
        opt = mx.query(sel, p=p, design="Horovod_MPI_Opt")[0]
        out.append(f"| {p} | " + " | ".join(cells)
                   + f" | {opt['efficiency']:.3f}"
                   f" | {opt['hidden_frac']:.2f} |")
    out.append("")
    return out


def _batch_table(rows: list[dict], profile: str) -> list[str]:
    out = [f"**{profile}** — images/sec per device vs per-device batch "
           "(Horovod_MPI_Opt):",
           "",
           "| model | p | " + " | ".join(f"b={b}" for b in mx.BATCHES)
           + " |",
           "|---|---|" + "---|" * len(mx.BATCHES)]
    sel = mx.query(rows, profile=profile, design="Horovod_MPI_Opt")
    for model in ("resnet50", "mobilenet"):
        for p in BATCH_WORKERS:
            cells = []
            for b in mx.BATCHES:
                r = mx.query(sel, model=model, p=p, batch_per_dev=b)
                cells.append(f"{r[0]['images_per_s'] / p:.0f}" if r
                             else "—")
            out.append(f"| {model} | {p} | " + " | ".join(cells) + " |")
    out.append("")
    return out


def render_markdown(rec: dict) -> str:
    n_pass = sum(c["status"] == "PASS" for c in rec["claims"])
    lines = [
        "# EXPERIMENTS — paper-claims characterization (the port)",
        "",
        "Regenerated by `PYTHONPATH=src python -m repro_torch.experiments."
        "regen` from the declarative experiment matrix "
        "(`src/repro_torch/experiments/matrix.py`) on the "
        "timeline-cost-model backend; `--check` and "
        "`tests/test_torch_experiments.py` fail if this file or "
        "`experiments.json` drifts from the registry. Every section equals "
        "the reference's `repro.experiments.regen.build_record()`. "
        "Dry-run/roofline tables for the LLM workloads are separate "
        "(`python -m repro_torch.launch.report`).",
        "",
        f"Schema `{rec['schema']}` — claims: {n_pass}/"
        f"{len(rec['claims'])} PASS.",
        "",
        "## Claims wall (C-class anchors, `experiments/claims.py`)",
        "",
    ]
    lines += _claims_table(rec["claims"])
    lines += [
        "",
        "Band-width rationale per claim class: the reference's DESIGN.md "
        "§3.7.",
        "",
        "## Micro: allreduce latency vs message size (Figs. 4/6)",
        "",
    ]
    for profile in ("paper", "v5e"):
        lines += _micro_table(rec["micro"], profile)
    lines += ["## Application scaling (Figs. 3/7/8/9)", ""]
    for profile in ("paper", "v5e"):
        for model in mx.MODELS:
            lines += _scaling_table(rec["scaling"], profile, model)
    lines += ["## Per-device batch (Fig. 2)", ""]
    for profile in ("paper", "v5e"):
        lines += _batch_table(rec["batch"], profile)
    lines += [
        "## Provenance",
        "",
        "- backend: timeline cost model (`core/cost_model.py` + "
        "`core/overlap.py`); constants from `core/hw.py` (the reference's "
        "TPU v5e model, not the card's) and the `experiments/matrix.py` "
        "profiles.",
        "- measured small-p counterpart: `matrix.measure_points` (the "
        "port's reducers on spawned ranks, same timeline composition): "
        "gloo ranks on the host in `tests/test_torch_measured_backend.py`, "
        "`cuda_ipc` and gloo ranks sharing one card in `chip_smoke.py` "
        "phase 16.",
        "- record: `experiments.json` "
        f"(schema `{rec['schema']}`).",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# write / check
# ---------------------------------------------------------------------------

def write(md_path: str = MD_ARTIFACT,
          json_path: str = JSON_ARTIFACT) -> dict:
    rec = build_record()
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(md_path, "w") as f:
        f.write(render_markdown(rec))
    return rec


def check(md_path: str = MD_ARTIFACT, json_path: str = JSON_ARTIFACT,
          telemetry_path: str = TELEMETRY_ARTIFACT) -> list[str]:
    """Return drift descriptions ([] = artifacts are current)."""
    rec = build_record()
    problems = []
    try:
        with open(json_path) as f:
            committed = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        committed = None
        problems.append(f"{os.path.basename(json_path)}: unreadable ({e})")
    if committed is not None:
        fresh = json.loads(json.dumps(rec))      # via-JSON floats
        if committed != fresh:
            drift = [k for k in fresh
                     if committed.get(k) != fresh[k]]
            problems.append(
                f"{os.path.basename(json_path)}: stale (sections "
                f"{drift or 'top-level'} differ from the registry)")
    try:
        with open(md_path) as f:
            md = f.read()
    except OSError as e:
        md = None
        problems.append(f"{os.path.basename(md_path)}: unreadable ({e})")
    if md is not None and md != render_markdown(rec):
        problems.append(f"{os.path.basename(md_path)}: stale")
    failing = [c["key"] for c in rec["claims"] if c["status"] != "PASS"]
    if failing:
        problems.append(f"claims outside their bands: {failing}")
    problems += check_telemetry_artifact(telemetry_path)
    return problems


def check_telemetry_artifact(path: str = TELEMETRY_ARTIFACT) -> list[str]:
    """Currency of the port's MEASURED telemetry-closure artifact
    (``artifacts_torch/telemetry_closure.json``, schema
    repro/telemetry/v1).  Its wall clocks cannot be re-derived
    deterministically, so currency means the check
    ``repro_torch.telemetry.closure.check_artifact`` runs WITHOUT
    re-measuring: the stored cells still match the canonical cell set,
    the stored predicted side still matches the CURRENT cost model
    (drift there means the model changed under the measurements —
    re-emit), and every gated residual sits inside the declared band.
    Refreshed on the host's CPU, where the band was declared, by
    ``python -m repro_torch.telemetry.closure --emit
    artifacts_torch/telemetry_closure.json --device cpu`` (8 gloo
    ranks)."""
    from ..telemetry import closure
    return closure.check_artifact(path)


def run_lines(ctx=None) -> list[str]:
    """One CSV line per claim (the reference's ``benchmarks/run.py``
    section).  Pass a shared claims.Ctx to reuse matrix rows another
    section already evaluated."""
    lines = []
    for c in claims_mod.evaluate(ctx=ctx):
        lines.append(
            f"claims.{c['key']},{c['value']:.4f},"
            f"band=[{c['lo']:g},{c['hi']:g}] {c['status']} "
            f"paper={c['paper_value']} ({c['anchor']})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.regen", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="verify the committed artifacts are current "
                         "(exit 1 on drift) instead of rewriting them")
    ap.add_argument("--out-md", default=MD_ARTIFACT)
    ap.add_argument("--out-json", default=JSON_ARTIFACT)
    args = ap.parse_args(argv)
    if args.check:
        problems = check(args.out_md, args.out_json)
        if problems:
            for p in problems:
                print(f"DRIFT: {p}")
            print("regenerate with: PYTHONPATH=src python -m "
                  "repro_torch.experiments.regen")
            return 1
        print(f"{os.path.basename(args.out_md)} and "
              f"{os.path.basename(args.out_json)} are current")
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out_md)),
                exist_ok=True)
    rec = write(args.out_md, args.out_json)
    n = len(rec["scaling"]) + len(rec["batch"]) + len(rec["micro"])
    print(f"wrote {n} matrix rows and {len(rec['claims'])} claims to "
          f"{os.path.normpath(args.out_md)} and "
          f"{os.path.normpath(args.out_json)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
