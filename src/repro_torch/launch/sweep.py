"""Dry-run sweep: every (arch × shape × mesh) as an isolated
subprocess of ``python -m repro_torch.launch.dryrun``, one JSON per
pair (results survive crashes; re-runs skip existing records).
Counterpart of ``repro/launch/sweep.py``, without its ``--trace``
(the port's dry run has none yet).

    PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun \
        [--multi-pod] [--archs a,b] [--shapes s1,s2] [--force]
"""
import argparse
import json
import os
import subprocess
import sys
import time


def pair_path(out_dir, arch, shape, mesh_tag, strategy):
    return os.path.join(out_dir,
                        f"{arch}__{shape}__{mesh_tag}__{strategy}.json")


def run_pair(out_dir, arch, shape, multi_pod, strategy="rhd_rsa",
             fusion_mb=4.0, timeout=1800, force=False, extra_args=()):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    path = pair_path(out_dir, arch, shape, mesh_tag, strategy)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--strategy", strategy,
           "--fusion-mb", str(fusion_mb), "--json", path]
    if multi_pod:
        cmd.append("--multi-pod")
    cmd.extend(extra_args)
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        if not os.path.exists(path):
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "strategy": strategy, "status": "FAIL",
                   "error": (proc.stderr or proc.stdout)[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
               "strategy": strategy, "status": "TIMEOUT",
               "seconds": timeout}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    with open(path) as f:
        rec = json.load(f)
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--strategy", default="rhd_rsa")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import SHAPES, list_archs
    os.makedirs(args.out, exist_ok=True)
    archs = args.archs.split(",") if args.archs else list_archs()
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            rec = run_pair(args.out, arch, shape, args.multi_pod,
                           args.strategy, timeout=args.timeout,
                           force=args.force)
            st = rec.get("status")
            n_ok += st == "OK"
            n_skip += st == "SKIP"
            n_fail += st in ("FAIL", "TIMEOUT")
            dom = rec.get("roofline", {}).get("dominant", "-")
            sched = rec.get("schedule")
            algs = ov = wire = ""
            if sched:
                # per-level decomposition straight from the IR record
                algs = " sched=" + (
                    sched.get("decomposition")
                    or "+".join(f"{s}x{n}" for s, n in
                                sorted(sched.get("algorithms", {})
                                       .items())))
                if sched.get("overlap"):
                    ov = (" overlap="
                          f"{sched['overlap']['overlap_fraction']*100:.0f}%")
                # measured counterpart: rendered only when the record
                # carries one, next to the predicted fraction
                mo = sched.get("measured_overlap")
                if mo:
                    ov += (" overlap_meas="
                           f"{mo['overlap_fraction']*100:.0f}%")
                wc = sched.get("wire_check")
                if wc:
                    wire = " wire=" + ("ok" if wc.get("consistent")
                                       else "MISMATCH")
            meas = ""
            m = rec.get("measured")
            if isinstance(m, dict) and "calibration" in m:
                meas = " residual=" + ("ok" if m.get("all_within_band")
                                       else "BAND")
            print(f"{st:7s} {arch:22s} {shape:12s} {rec.get('mesh')} "
                  f"dominant={dom}{algs}{ov}{wire}{meas} "
                  f"wall={rec.get('wall_s', 0)}s",
                  flush=True)
    print(f"done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
