#!/usr/bin/env python3
"""chip_smoke.py's phase 3 on both transports, and its phase 10, from
the chip_smoke.py of any checkout, on one card.

    python3 tools/phase_compare.py [--tree DIR] [--model-axis]

Builds the kernels of ``--tree`` (default: this checkout) and runs that
tree's ``chip_smoke.run_phase`` on phase 3's configuration (full-width
smollm-360m, seq 512, 4 ranks, batch 2 each, ``rhd_rsa`` + ``int8``
fused hops, K5 AdamW, 3 steps) over gloo, then over ``cuda_ipc``, with
every check that phase makes; with ``--model-axis`` then phase 10 (the
data 2 x model 2 mesh, ``run_model_axis_phase``).  Two trees run one
after the other in one call compare on the same card (parent, change,
change, parent).  The last line is one JSON object: the tree, the card,
and per transport each step's seconds (rank 0) and the aggregate timed
alone (every rank).  It exits non-zero without a card.
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
    ap.add_argument("--model-axis", action="store_true",
                    help="run phase 10 after phase 3 (this tree's only)")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    if not torch.cuda.is_available():
        print("phase_compare: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import backend
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    cs.log(f"tree {tree}; nvidia-smi: {gpu}")
    t0 = time.perf_counter()
    backend.build_all()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    args = cs.train_args(full=True, batch=2 * cs.TRAIN_WORLD, seq=512,
                         device="cuda")
    small = cs.train_args(full=False, batch=2 * cs.TRAIN_WORLD, seq=32,
                          steps=2, dtype="float32")
    main_path = ("hop_absmax", "hop_encode", "hop_decode_add",
                 "adamw_update", "fused_rmsnorm")
    out = {"tree": tree, "gpu": gpu}
    phase3 = None
    for transport in ("gloo", "cuda_ipc"):
        cs.log(f"phase 3 on {transport}")
        recs = cs.run_phase(cs.TRAIN_WORLD, args, small, main_path,
                            backend=transport)
        phase3 = phase3 or recs
        out[transport] = {
            "step_s": [s["step_s"] for s in recs[0]["steps"]],
            "aggregate_s": [r["breakdown"]["aggregate_s"] for r in recs],
            "launches": recs[0]["steps"][-1]["launches"]}
    if a.model_axis:
        t1 = time.perf_counter()
        cs.log("phase 10")
        cs.run_model_axis_phase(phase3)
        out["phase10_s"] = time.perf_counter() - t1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
