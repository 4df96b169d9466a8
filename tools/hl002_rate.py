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
the backward's host time, when it began after the first rank's (where
the tree records it), and when the first bucket's hops ended, in ms
from the start of backward, and the split of the buckets' hop host
time: issue, waiting on the host for the peer's notify
(``cuda_ipc.notify_wait``) and for its acknowledgement
(``cuda_ipc.ack_wait``; a tree whose hops wait on the card has neither),
summed over the step's buckets and for its slowest bucket, and the
host's wait for the channel at the backward's join (``cuda_ipc.sync``).
The split reads the ranks' trace spans; a tree whose transport opens no
trace span around its waits gets them from this script, which wraps the
tree's ``dist._span`` in the ranks.  Where the tree records the card's
clock (``OverlapRecord.device_backward_s``) each rank-step also prints
the buckets that ended on the card before the backward's last kernel
and the device overlap fraction.  HL002 holds on a step when the witness
is at least 1.  Two trees run one after the other in one call compare
on the same card (parent, change, change, parent).  The last line is
one JSON object: the tree, the card, and per run the rank-steps that failed HL002 and each
rank-step's split (ms: issue, notify wait, ack wait, the slowest
bucket's hop time, the join's wait; then the card's witness and overlap
fraction, or None).  It exits non-zero without a card.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAITS = ("cuda_ipc.notify_wait", "cuda_ipc.ack_wait")


def _split(bucket):
    """``(issue, notify wait, ack wait, hops)`` host seconds of one
    bucket span's hops."""
    from repro_torch.telemetry.trace import walk
    hops = [s for s in walk([bucket]) if s.name.startswith("hop[")]
    waits = [sum(w.duration_s for h in hops for w in walk(h.children)
                 if w.name == name) for name in WAITS]
    total = sum(h.duration_s for h in hops)
    return (total - sum(waits), *waits, total)


def _traced_rank(rank, world, *args):
    """The tree's phase 11 rank, its control waits traced, and the split
    of the overlapped ResNet-50's hops (part (b): the first overlap
    channel's bucket spans, ``CNN_BUCKETS["resnet50"]`` a step)."""
    import chip_smoke as cs
    from repro_torch import telemetry
    from repro_torch.core import dist
    if not hasattr(dist, "_wait_span"):
        plain = dist._span

        @contextlib.contextmanager
        def both(name):
            with plain(name), telemetry.get_tracer().span(name, cat="trace"):
                yield

        dist._span = lambda name: both(name) if name in WAITS \
            else plain(name)
    out = cs.telemetry_rank(rank, world, *args)
    roots = [s for s in telemetry.get_tracer().roots
             if s.name.startswith("bucket[")
             and s.attrs.get("thread") == "overlap-channel"]
    n = cs.CNN_BUCKETS["resnet50"]
    steps = cs.CNN_WARMUP + cs.CNN_TIMED
    out["hop_split"] = [[_split(b) for b in roots[i * n:(i + 1) * n]]
                        for i in range(steps)]
    return out


def _card(step):
    """``(buckets ended before the backward's last kernel, device overlap
    fraction)`` on the card's clock, or None where the tree records no
    card clock."""
    if step.get("device_witness") is None:
        return None
    return step["device_witness"], round(step["device_overlap"], 4)


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
    cs.telemetry_rank = _traced_rank
    out = {"tree": tree, "gpu": gpu, "runs": []}
    for run in range(a.runs):
        n0 = len(lint_failures)
        results = cs.run_telemetry_phase(None, None)
        splits = []
        # when each rank's backward began after the first rank's (a tree
        # whose records carry t0, the host's monotonic clock)
        t0s = [[st.get("t0") for st in r["cnn"]["steps"]] for r in results]
        for r in results:
            for s_, step in enumerate(r["cnn"]["steps"], 1):
                starts = [t[s_ - 1] for t in t0s]
                begun = "not recorded" if None in starts else \
                    f"{(step['t0'] - min(starts)) * 1e3:.2f} ms"
                first = min(end for _i, _ready, _start, end, *_ in
                            step["buckets"])
                sp = r["hop_split"][s_ - 1]
                tot = [sum(b[i] for b in sp) * 1e3 for i in range(3)]
                worst = max(sp, key=lambda b: b[3])
                join = step.get("join_wait_s", 0.0) * 1e3
                card = _card(step)
                splits.append([r["rank"], s_] + [round(x, 3) for x in tot]
                              + [round(worst[3] * 1e3, 3), round(join, 3),
                                 card])
                cs.log(f"  run {run} rank {r['rank']} step {s_}: HL002 "
                       f"witness {step['lint']['witness']}, backward "
                       f"{step['backward_s'] * 1e3:.2f} ms begun {begun} "
                       f"after the first rank's, first bucket's "
                       f"hops ended at {first * 1e3:.2f} ms; hops of "
                       f"{len(sp)} buckets: issue {tot[0]:.2f}, notify "
                       f"wait {tot[1]:.2f}, ack wait {tot[2]:.2f} ms; "
                       f"slowest bucket {worst[3] * 1e3:.2f} ms (issue "
                       f"{worst[0] * 1e3:.2f}, notify {worst[1] * 1e3:.2f}"
                       f", ack {worst[2] * 1e3:.2f}); the join's wait "
                       f"{join:.2f} ms; channel thread nice "
                       f"{step.get('channel_nice', 'not set')}; on the card: "
                       + ("not recorded" if card is None else
                          f"{card[0]} buckets ended before the backward's "
                          f"last kernel, overlap fraction {card[1]}"))
        failed = [f for f in lint_failures[n0:]
                  if f[0] == "ResNet-50 overlapped"
                  and all("HL002" in d for d in f[3])]
        other = [f for f in lint_failures[n0:] if f not in failed]
        if other:
            raise AssertionError(f"the hop lint found more than HL002 on "
                                 f"ResNet-50: {other}")
        out["runs"].append({"hl002_failed": [[rk, st] for _l, rk, st, _d
                                              in failed],
                            "split_ms": splits})
        cs.log(f"run {run}: HL002 failed on {len(failed)} of "
               f"{sum(len(r['cnn']['steps']) for r in results)} rank-steps")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
