"""``python -m repro_torch.analysis`` — the static-verification gate.

Counterpart of ``python -m repro.analysis``, with its modes, its JSON
summary and its exit status (default = ``--source --schedules``):

``--source``          import-lint the port's sources (IL rules); an
                      error when ``--root`` lacks them.
``--schedules``       verify every cell of ``experiments/matrix
                      .analysis_cells`` (SV rules), the 512-rank and
                      composed two-level schedules included.
``--schedule-json F`` verify one serialized ReduceSchedule
                      (``repro/schedule/v1`` JSON, as ``to_json`` or a
                      dry-run record writes it).
``--check-baseline``  also fail on warnings the baseline
                      (``analysis/baseline.json``) does not accept.
``--json OUT``        write the full diagnostic summary as JSON.

Exit status: non-zero iff any ``error`` diagnostic fired (or, with
``--check-baseline``, any unbaselined warning).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import errors, hop_lint, summarize, warnings as warn_of


def _verify_schedules(diags: list) -> int:
    from ..experiments import matrix
    from . import verify as verify_mod
    n = 0
    for label, sched in matrix.analysis_cells():
        diags.extend(verify_mod.verify_schedule(sched, context=label))
        n += 1
    return n


def _verify_schedule_json(path: str, diags: list) -> None:
    from ..core import schedule as schedule_mod
    from . import verify as verify_mod
    with open(path) as f:
        rec = json.load(f)
    sched = schedule_mod.from_json(rec)
    diags.extend(verify_mod.verify_schedule(sched, context=path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--source", action="store_true",
                    help="import-lint the port's sources")
    ap.add_argument("--schedules", action="store_true",
                    help="verify every experiment-matrix schedule cell")
    ap.add_argument("--schedule-json",
                    help="verify one repro/schedule/v1 JSON record")
    ap.add_argument("--check-baseline", action="store_true",
                    help="fail on warnings not in the baseline")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default "
                         f"{hop_lint.BASELINE_FILE})")
    ap.add_argument("--root", default=".",
                    help="repo root for --source (default .)")
    ap.add_argument("--json", dest="json_out",
                    help="write the diagnostic summary to this path")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    run_source = args.source
    run_schedules = args.schedules
    if not (run_source or run_schedules or args.schedule_json):
        run_source = run_schedules = True

    diags: list = []
    n_cells = n_files = 0
    if run_source:
        from . import import_lint
        diags.extend(import_lint.lint_tree(args.root))
        n_files = sum(1 for _ in import_lint.iter_source_files(args.root))
    if run_schedules:
        n_cells = _verify_schedules(diags)
    if args.schedule_json:
        _verify_schedule_json(args.schedule_json, diags)

    errs = errors(diags)
    warns = warn_of(diags)
    failing = list(errs)
    if args.check_baseline:
        baseline = hop_lint.load_baseline(args.baseline)
        failing += hop_lint.unbaselined_warnings(warns, baseline)

    if not args.quiet:
        for d in diags:
            print(d.render())
        scope = []
        if run_source:
            scope.append(f"{n_files} source files")
        if run_schedules:
            scope.append(f"{n_cells} schedule cells")
        if args.schedule_json:
            scope.append(args.schedule_json)
        print(f"[analysis] {' + '.join(scope)}: {len(errs)} error(s), "
              f"{len(warns)} warning(s)"
              + (f", {len(failing) - len(errs)} unbaselined"
                 if args.check_baseline else ""))
    if args.json_out:
        extra = {"n_cells": n_cells}
        if run_source:
            extra["n_source_files"] = n_files
        with open(args.json_out, "w") as f:
            json.dump(summarize(diags, extra=extra), f, indent=1)
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
