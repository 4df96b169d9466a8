#!/usr/bin/env python3
"""chip_smoke's phase 5 (the paper's CNNs on gloo) from several trees of
this repository, in turns on one card.

    python3 tools/cnn_phase_compare.py --tree parent=DIR --tree change=. \
        [--rounds N]

Each ``--tree NAME=DIR`` names a checkout (or a ``git archive`` of one).
For each turn (first, second, ..., ..., second, first; that sequence
``--rounds`` times) a process of its own, with ``DIR/src`` on its path,
builds that tree's kernels and runs its ``chip_smoke.run_cnn_phase()``
with its defaults: ResNet-50 and
MobileNet-v1 at 224x224 on 4 ranks, every strategy, with that tree's
checks.  The script then prints, per model and strategy, each turn's
images/s (over the timed steps of rank 0) and its aggregate seconds (the
aggregate timed alone after the main path, per rank).  It exits
non-zero without a card, or when a turn fails.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import gpu_line, log, require  # noqa: E402

RUN = """
import json, sys
import chip_smoke
from repro_torch.kernels import backend
backend.build_all()
results = chip_smoke.run_cnn_phase()
out = []
for i, run in enumerate(results[0]["runs"]):
    timed = run["steps"][chip_smoke.CNN_WARMUP:]
    out.append({"model": run["model"], "strategy": run["strategy"],
                "images_per_s": chip_smoke.CNN_BATCH * len(timed)
                / sum(s["step_s"] for s in timed),
                "aggregate_s": [r["runs"][i]["breakdown"]["aggregate_s"]
                                for r in results]})
print("RESULT " + json.dumps(out), flush=True)
"""


def run_tree(name, path):
    """One turn: the tree's phase 5 in a process of its own."""
    path = os.path.abspath(path)
    out = subprocess.run(
        [sys.executable, "-c", RUN], cwd=path,
        env={**os.environ, "PYTHONPATH": os.path.join(path, "src")},
        capture_output=True, text=True, timeout=900)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("RESULT ")]
    require(out.returncode == 0 and lines,
            f"[{name}] phase 5 failed:\n{out.stdout[-4000:]}\n"
            f"{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a tree to run (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cnn_phase_compare: no CUDA device available", file=sys.stderr)
        return 1
    trees = [spec.split("=", 1) for spec in args.tree]
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{gpu_line()}; torch {torch.__version__} cuda {torch.version.cuda}")
    order = (trees + trees[::-1]) * args.rounds
    turns = []
    for name, path in order:
        log(f"turn {len(turns) + 1}: {name} ({path})")
        turns.append((name, run_tree(name, path)))
        for rec in turns[-1][1]:
            log(f"  {rec['model']} {rec['strategy']}: images/s "
                f"{rec['images_per_s']:.1f}, aggregate_s "
                f"{[round(a, 4) for a in rec['aggregate_s']]}")
    log(f"phase 5 in turns ({' '.join(n for n, _ in order)}) on "
        f"{gpu_line()}:")
    for i, rec in enumerate(turns[0][1]):
        key = (rec["model"], rec["strategy"])
        for name, _ in trees:
            got = [t[i] for n, t in turns if n == name]
            require(all((g["model"], g["strategy"]) == key for g in got),
                    "trees ran the strategies in different orders")
            log(f"  {key[0]} {key[1]} {name}: images/s "
                f"{[round(g['images_per_s'], 1) for g in got]}, aggregate_s "
                f"(max over ranks) "
                f"{[round(max(g['aggregate_s']), 4) for g in got]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
