#!/usr/bin/env python3
"""How often chip_smoke.py's phase 11(b) HL002 gate holds, from the
chip_smoke.py of any checkout, on one card.

    python3 tools/hl002_rate.py [--tree DIR] [--runs N]

Builds the kernels of ``--tree`` (default: this checkout) and runs that
tree's phase 11 (``run_telemetry_phase``: one 4-rank ``cuda_ipc`` spawn,
ResNet-50 ``rhd_rsa`` overlapped for 1 + 2 steps among its parts)
``--runs`` times.  Its lint check records instead of stopping the run,
so every run prints, per rank and step, HL002's witness (buckets whose
hops all ended before that rank's backward did, of those with hops),
the backward's host time and when the first bucket's hops ended, both
in ms from the start of backward.  HL002 holds on a step when the
witness is at least 1.  Two trees run one after the other in one call
compare on the same card (parent, change, change, parent).  The last
line is one JSON object: the tree, the card, and per run the rank-steps
that failed HL002.  It exits non-zero without a card.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose chip_smoke.py and src/ run")
    ap.add_argument("--runs", type=int, default=3)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    # the spawned ranks import the tree's chip_smoke and repro_torch
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [tree, os.path.join(tree, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    import torch
    if not torch.cuda.is_available():
        print("hl002_rate: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import backend
    gpu = cs.gpu_line()
    cs.log(f"tree {tree}; nvidia-smi: {gpu}")
    t0 = time.perf_counter()
    backend.build_all()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    lint_failures = []

    def record_lint(rank, label, steps):
        for s_, step in enumerate(steps, 1):
            found = step["lint"]["errors"] + step["lint"]["warnings"]
            if found:
                lint_failures.append((label, rank, s_, found))
    cs._require_lint = record_lint
    out = {"tree": tree, "gpu": gpu, "runs": []}
    for run in range(a.runs):
        n0 = len(lint_failures)
        results = cs.run_telemetry_phase(None, None)
        for r in results:
            for s_, step in enumerate(r["cnn"]["steps"], 1):
                first = min(end for _i, _ready, _start, end, *_ in
                            step["buckets"])
                cs.log(f"  run {run} rank {r['rank']} step {s_}: HL002 "
                       f"witness {step['lint']['witness']}, backward "
                       f"{step['backward_s'] * 1e3:.2f} ms, first bucket's "
                       f"hops ended at {first * 1e3:.2f} ms")
        failed = [f for f in lint_failures[n0:]
                  if f[0] == "ResNet-50 overlapped"
                  and all("HL002" in d for d in f[3])]
        other = [f for f in lint_failures[n0:] if f not in failed]
        if other:
            raise AssertionError(f"the hop lint found more than HL002 on "
                                 f"ResNet-50: {other}")
        out["runs"].append({"hl002_failed": [[rk, st] for _l, rk, st, _d
                                              in failed]})
        cs.log(f"run {run}: HL002 failed on {len(failed)} of "
               f"{sum(len(r['cnn']['steps']) for r in results)} rank-steps")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
