#!/usr/bin/env python3
"""The post-backward and the overlapped train step in turns, on one card.

    python3 tools/overlap_compare.py [--rounds N] [--steps S]

One spawn of 4 ranks on the ``cuda_ipc`` transport trains chip_smoke's
phase-8 configurations, ResNet-50 ``rhd_rsa`` (deterministic cuDNN,
224x224, 32 images per rank) and smollm-360m ``rhd_rsa`` + ``int8`` (seq
512, batch 2 per rank), each with ``overlap=False`` and ``overlap=True``
in turns (post, overlap, overlap, post; ``--rounds`` times), ``--steps``
steps a turn from the same initial parameters.  Per turn it prints rank
0's step seconds (the first step of a turn is its warm-up), each rank's
checksum (every turn of a model must agree bit for bit), and for an
overlapped turn each rank's backward, communication, hidden seconds and
per-bucket channel seconds of the last step.  Then one more step of each
placement runs under ``torch.profiler`` on every rank, and rank 0's ops
with the most self CPU time are printed (the profiler records the
calling thread: the channel thread's own ops do not show).  It exits
non-zero without a card.
"""
import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs  # noqa: E402

MODELS = ("resnet50", "smollm-360m")


def _trainer(model, overlap, group):
    import dataclasses
    from repro_torch.launch.train import aggregator_config, build_trainer
    if model == "resnet50":
        return cs.cnn_trainer("resnet50", "rhd_rsa", cs.CNN_IMAGE,
                              cs.CNN_BATCH, "bfloat16", "cuda", group,
                              data_device="cuda", overlap=overlap)
    args = cs.train_args(full=True, batch=2 * cs.TRAIN_WORLD, seq=512,
                         device="cuda")
    return build_trainer(args, verbose=False, groups={"data": group},
                         aggregator=dataclasses.replace(
                             aggregator_config(args), overlap=overlap))


def _top_ops(prof, n=12):
    rows = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    return [(round(ms, 2), count, key) for ms, count, key in rows[:n]]


def compare_rank(rank, world, rounds, steps):
    import torch
    from repro_torch.core import Group, plan_cache
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    group = Group()
    act = torch.profiler.ProfilerActivity
    out = {}
    for model in MODELS:
        turns = []
        for overlap in (False, True, True, False) * rounds:
            tr = _trainer(model, overlap, group)
            module, state = tr.init_state(0)
            times = []
            for s in range(steps):
                module, state, hist = tr.run(1, module, state, start_step=s)
                times.append(hist[0]["step_s"])
            turns.append({"overlap": overlap, "step_s": times,
                          "checksum": cs._checksum(module.tree()),
                          "channel": cs._overlap_summary(tr)
                          if overlap else None})
            del tr, module, state
            plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
            torch.cuda.empty_cache()
        profiles = {}
        for overlap in (False, True):
            tr = _trainer(model, overlap, group)
            module, state = tr.init_state(0)
            module, state, _ = tr.run(1, module, state)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[act.CPU,
                                                    act.CUDA]) as prof:
                tr.run(1, module, state, start_step=1)
                torch.cuda.synchronize()
            profiles[overlap] = _top_ops(prof) if rank == 0 else None
            del tr, module, state
            plan_cache.GLOBAL_EXECUTOR_CACHE.clear()
            torch.cuda.empty_cache()
        out[model] = {"turns": turns, "profiles": profiles}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("overlap_compare: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import backend
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.gpu_line()}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    backend.build_all()
    with tempfile.TemporaryDirectory() as rdv:
        res = run_ranks(compare_rank, cs.TRAIN_WORLD,
                        (args.rounds, args.steps), backend="cuda_ipc",
                        rendezvous_dir=rdv,
                        threads=max(1, (os.cpu_count() or 1)
                                    // cs.TRAIN_WORLD), timeout_s=1800)
    for model in MODELS:
        cs.log(f"{model}, 4 ranks on cuda_ipc:")
        turns = [r[model]["turns"] for r in res]
        for t, turn in enumerate(turns[0]):
            label = "overlap" if turn["overlap"] else "post"
            sums = {tt[t]["checksum"] for tt in turns}
            cs.log(f"  turn {t + 1} {label:7s}: rank 0 step_s "
                   f"{[round(s, 4) for s in turn['step_s']]}; checksums "
                   f"{sorted(sums)}")
            cs.require(len(sums) == 1, f"{model} turn {t + 1}: ranks "
                                       f"differ")
            for r, tt in enumerate(turns):
                ch = tt[t]["channel"]
                if ch is None:
                    continue
                m = ch["measured"]
                cs.log(f"    rank {r}: backward {ch['backward_s'] * 1e3:.1f}"
                       f" ms, communication {m['comm_s'] * 1e3:.1f}, hidden "
                       f"{m['hidden_comm_s'] * 1e3:.1f}; per bucket ms "
                       f"{[round((b[4] - b[3]) * 1e3, 1) for b in ch['buckets']]}")
        cs.require(len({tt["checksum"] for tt in turns[0]}) == 1,
                   f"{model}: the placements differ")
        for overlap, rows in res[0][model]["profiles"].items():
            cs.log(f"  rank 0, a profiled {'overlapped' if overlap else 'post-backward'} "
                   f"step, most self CPU (ms, calls, op):")
            for row in rows:
                cs.log(f"    {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
