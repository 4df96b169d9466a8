"""Aggregate dry-run JSON records into Markdown tables.

Counterpart of ``repro/launch/report.py``, verbatim in its rendering:
given the same records the two render the same Markdown.

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun

Emits the status matrix per mesh (status / per-device HBM args+temp /
collective bytes; the HBM column divides each record's ``memory`` by the
mesh's chip count, as the reference's does), the roofline table (three
terms, dominant, MODEL_FLOPS ratio), the reduction schedules and, for
traced records, the closure table, to stdout.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(n):
    if n >= 2 ** 30:
        return f"{n / 2 ** 30:.2f} GiB"
    if n >= 2 ** 20:
        return f"{n / 2 ** 20:.1f} MiB"
    return f"{n / 2 ** 10:.1f} KiB"


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f} s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f} ms"
    return f"{x * 1e6:.1f} µs"


SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def dryrun_matrix(recs, mesh):
    rows = {}
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        rows.setdefault(r["arch"], {})[r["shape"]] = r
    out = [f"**Mesh {mesh}** — status / per-device HBM args+temp / "
           "collective bytes per step:",
           "",
           "| arch | " + " | ".join(SHAPE_ORDER) + " |",
           "|---|" + "---|" * len(SHAPE_ORDER)]
    for arch in sorted(rows):
        cells = []
        for s in SHAPE_ORDER:
            r = rows[arch].get(s)
            if r is None:
                cells.append("—")
            elif r["status"] == "SKIP":
                # ✓ = the unexecutable schedule was still statically
                # verified (zero error diagnostics)
                cells.append("SKIP†✓" if r.get("verified_static")
                             else "SKIP†")
            elif r["status"] != "OK":
                cells.append(f"**{r['status']}**")
            else:
                mem = r.get("memory", {})
                dev = (mem.get("argument_size_in_bytes", 0)
                       + mem.get("temp_size_in_bytes", 0)) / 256
                if r["mesh"].startswith("2x"):
                    dev = (mem.get("argument_size_in_bytes", 0)
                           + mem.get("temp_size_in_bytes", 0)) / 512
                coll = r["collectives"]["total_bytes"]
                cells.append(f"OK {fmt_bytes(dev)} / {fmt_bytes(coll)}")
        out.append(f"| {arch} | " + " | ".join(cells) + " |")
    out.append("")
    return "\n".join(out)


def roofline_table(recs, mesh="16x16"):
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "MODEL_FLOPS/HLO_FLOPs |",
           "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"],
                                         SHAPE_ORDER.index(x["shape"]))):
        if r.get("mesh") != mesh or r["status"] != "OK":
            continue
        rf = r["roofline"]
        ratio = rf["model_flops"] / max(rf["flops"] * rf["chips"], 1)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {ratio:.2f} |")
    return "\n".join(out)


def schedule_table(recs):
    """Per-bucket reduction schedules (strategy='auto' mixes algorithms
    per step): the per-level decomposition of the serialized
    ReduceSchedule IR (schema repro/schedule/v1), selector-predicted
    comm latency vs the charged collective term."""
    rows = [r for r in recs
            if r.get("status") == "OK" and r.get("schedule")]
    if not rows:
        return ""
    # measured overlap column (traced records, the telemetry closure)
    # is rendered ONLY when at least one record carries it.
    has_measured = any(r["schedule"].get("measured_overlap")
                       for r in rows)
    meas_hdr = "comm hidden (measured) | " if has_measured else ""
    meas_sep = "---|" if has_measured else ""
    out = ["### Reduction schedules (per-bucket algorithm selection "
           "+ predicted overlap)\n",
           "| arch | shape | buckets | decomposition | verify | "
           "predicted comm | charged comm | wire bytes (pred→charged) | "
           f"comm hidden | {meas_hdr}step serial→overlapped |",
           "|---|---|---|---|---|---|---|---|---|" + meas_sep + "---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        s = r["schedule"]
        # fed straight from the serialized IR; older records without an
        # "ir" block fall back to the algorithms summary
        ir = s.get("ir") or {}
        algs = ir.get("decomposition") or s.get("decomposition") or \
            " + ".join(f"{k}×{v}" for k, v in
                       sorted(s.get("algorithms", {}).items()))
        ov = s.get("overlap")
        if ov:
            hidden = f"{ov['overlap_fraction'] * 100:.0f}%"
            step = (f"{fmt_s(ov['step_serial_s'])} → "
                    f"{fmt_s(ov['step_overlapped_s'])}")
        else:
            hidden = step = "—"
        mo = s.get("measured_overlap")
        measured = (f"{mo['overlap_fraction'] * 100:.0f}%"
                    if mo else "—") if has_measured else None
        wc = s.get("wire_check")
        if wc:
            mark = "✓" if wc["consistent"] else "**✗**"
            wire = (f"{fmt_bytes(wc['predicted_total'])} → "
                    f"{fmt_bytes(wc['charged_total'])} {mark}")
        else:
            wire = "—"
        # static-verifier verdict over the resolved IR
        vr = s.get("verify")
        if vr is None:
            verified = "—"
        elif vr.get("n_errors", 0) == 0:
            verified = "✓"
        else:
            verified = f"**✗ {vr['n_errors']}**"
        meas_cell = f"{measured} | " if has_measured else ""
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{s['n_buckets']} | {algs} | {verified} | "
            f"{fmt_s(s['predicted_comm_s'])} | "
            f"{fmt_s(s['charged_comm_s'])} | {wire} | {hidden} | "
            f"{meas_cell}{step} |")
    return "\n".join(out) + "\n"


def telemetry_table(recs):
    """Measured-vs-predicted closure summaries: the per-record residual
    table of the telemetry closure — stages replayed as real
    collectives, calibrated against the cost model, gated by the
    residual band.  Empty string when no record carries one."""
    rows = [r for r in recs
            if isinstance(r.get("measured"), dict)
            and "calibration" in r["measured"]]
    if not rows:
        return ""
    out = ["### Telemetry closure (measured stage replays vs cost "
           "model)\n",
           "| arch | shape | stages (gated) | calibration k | "
           "max ratio | band | within |",
           "|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        m = r["measured"]
        band = m.get("band", {})
        mark = "✓" if m.get("all_within_band") else "**✗**"
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{m['n_stages']} ({m['n_gated']}) | "
            f"{m['calibration']['k']:.3g} | {m['max_ratio']:.2f} | "
            f"≤{band.get('factor', 0):g}× | {mark} |")
    return "\n".join(out) + "\n"


def skips(recs):
    seen = set()
    out = []
    for r in recs:
        if r["status"] == "SKIP" and r["arch"] not in seen:
            seen.add(r["arch"])
            out.append(f"- `{r['arch']}` × `{r['shape']}`: {r['reason']}")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args()
    recs = load(args.dir)
    n_ok = sum(r["status"] == "OK" for r in recs)
    n_skip = sum(r["status"] == "SKIP" for r in recs)
    n_fail = len(recs) - n_ok - n_skip
    print(f"records: {len(recs)} — {n_ok} OK, {n_skip} SKIP, "
          f"{n_fail} FAIL\n")
    for mesh in ("16x16", "2x16x16"):
        print(dryrun_matrix(recs, mesh))
    print("† skips:\n" + skips(recs) + "\n")
    print("### Roofline (single-pod 16x16, per device per step)\n")
    print(roofline_table(recs))
    sched = schedule_table(recs)
    if sched:
        print()
        print(sched)
    tele = telemetry_table(recs)
    if tele:
        print()
        print(tele)


if __name__ == "__main__":
    main()
