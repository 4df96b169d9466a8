#!/usr/bin/env python3
"""Host and device time of ``cuda_ipc`` hops, from the ``src/`` of any
checkout, on one card.

    python3 tools/hop_probe.py [--tree DIR] [--parts pingpong,resnet,sizes]

Spawns ranks sharing the card on the tree's ``cuda_ipc`` transport and
times back-to-back collectives through one channel:

* ``pingpong``: p = 2 and 4 ranks, each hop a ring ``ppermute`` of 4 KiB
  (with p = 2 a ping-pong), 20 warm-up hops, then 100 timed;
* ``resnet``: 4 ranks, ``rhd_rsa`` on every distinct ResNet-50 bucket
  size of the paper's Horovod_MPI design (``matrix.bucket_sizes``),
  float32, 2 warm-up calls, then 5 timed;
* ``sizes``: 8 ranks, ``ring_rsa`` and ``rhd_rsa`` on 1, 4 and 16 MiB,
  as the closure's card cells, 2 warm-up calls, then 5 timed.

Per rank and case: the host's seconds until the timed calls returned
(its issue time; on a tree whose hops wait on the host, its waits too),
the card's seconds from an event before them to one after them on the
stream (the hops' latency on the card), each divided by the hops this
rank took part in (half the control messages it counted: a notify and
an acknowledgement per hop).  Two trees run one after the other in one call compare on the same card
(parent, change, change, parent).  The last line is one JSON object:
the tree, the card, and per part and case the slowest rank's
milliseconds a hop, host and card.  It exits non-zero without a card.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINGPONG_BYTES = 4096
PINGPONG_HOPS = (20, 100)          # warm-up, timed
CALLS = (2, 5)                     # warm-up, timed
SIZES_MIB = (1, 4, 16)


def _timed(fn, warm, timed, channel):
    """``(host s, card s, hops)`` of ``timed`` calls of ``fn`` after
    ``warm`` (the card's clock from events on the current stream)."""
    import torch
    import torch.distributed as tdist
    from repro_torch.core import dist
    for _ in range(warm):
        fn()
    _settle(torch, channel)
    tdist.barrier()
    msgs = dist.traffic["control_messages"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(timed):
        fn()
    host = time.perf_counter() - t0
    end.record()
    _settle(torch, channel)
    hops = (dist.traffic["control_messages"] - msgs) / 2
    return host, start.elapsed_time(end) / 1e3, hops


def _settle(torch, channel):
    sync = getattr(channel, "sync", None)
    if sync is not None:
        sync()
    torch.cuda.synchronize()


def _rank(rank, world, parts):
    import torch
    from repro_torch.core import dist, reducers
    torch.cuda.set_device(0)
    group = dist.Group()
    out = {}
    if "pingpong" in parts:
        n = PINGPONG_BYTES // 4
        x = torch.full((n,), float(rank), device="cuda")
        ring = [(i, (i + 1) % world) for i in range(world)]
        with dist.IpcChannel(group, PINGPONG_BYTES, "cuda") as ch:
            out[f"pingpong p={world}"] = _timed(
                lambda: dist.ppermute(x, ch.group, ring),
                PINGPONG_HOPS[0], PINGPONG_HOPS[1], ch)
    for strategy, sizes in parts.get("allreduce", ()):
        for nbytes in sizes:
            n = max(nbytes // 4, 1)
            x = torch.full((n,), float(rank + 1), device="cuda")
            with dist.IpcChannel(group, nbytes, "cuda") as ch:
                out[f"{strategy} p={world} {nbytes} B"] = _timed(
                    lambda: reducers.allreduce(x, [ch.group], strategy),
                    CALLS[0], CALLS[1], ch)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose src/ runs")
    ap.add_argument("--parts", default="pingpong,resnet,sizes")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [tree, os.path.join(tree, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    import torch
    if not torch.cuda.is_available():
        print("hop_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import dist
    from repro_torch.experiments import matrix
    from repro_torch.kernels import backend
    gpu = cs.gpu_line()
    cs.log(f"tree {tree}; nvidia-smi: {gpu}")
    backend.build_all(("mailbox",))      # the transport's only build
    mib = [m << 20 for m in SIZES_MIB]
    runs = []
    wanted = a.parts.split(",")
    if "pingpong" in wanted:
        runs += [(p, {"pingpong": True}) for p in (2, 4)]
    if "resnet" in wanted:
        runs.append((4, {"allreduce": [(
            "rhd_rsa", matrix.bucket_sizes("resnet50", "Horovod_MPI"))]}))
    if "sizes" in wanted:
        runs.append((8, {"allreduce": [("ring_rsa", mib),
                                       ("rhd_rsa", mib)]}))
    out = {"tree": tree, "gpu": gpu, "ms_per_hop": {}}
    for world, parts in runs:
        with tempfile.TemporaryDirectory() as rdv:
            t0 = time.perf_counter()
            res = dist.run_ranks(_rank, world, (parts,),
                                 backend="cuda_ipc", rendezvous_dir=rdv,
                                 threads=max(1, (os.cpu_count() or 1)
                                             // world), timeout_s=600)
        cs.log(f"  {world} ranks in {time.perf_counter() - t0:.1f} s")
        for case in res[0]:
            host = max(r[case][0] / r[case][2] for r in res) * 1e3
            card = max(r[case][1] / r[case][2] for r in res) * 1e3
            hops = res[0][case][2]
            out["ms_per_hop"][case] = {"host": round(host, 5),
                                       "card": round(card, 5),
                                       "hops": hops}
            cs.log(f"    {case}: {hops:.0f} hops a rank; ms a hop, slowest "
                   f"rank: host {host:.4f}, card {card:.4f}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
