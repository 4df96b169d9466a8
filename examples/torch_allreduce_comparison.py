"""The paper in one script, on the port: train the SAME model with every
gradient-aggregation design and show (1) the same learning curve for
each — the algorithm preserves the semantics, (2) the schedule each one
runs, (3) each one's latency under the cost model.

    PYTHONPATH=src python examples/torch_allreduce_comparison.py
    PYTHONPATH=src python examples/torch_allreduce_comparison.py --device cpu

Counterpart of ``examples/allreduce_comparison.py`` in ``repro_torch``:
8 spawned ranks laid out as 2 pods × 4 data ranks
(``launch.mesh.make_groups``), the reduced smollm-360m, AdamW, 6 steps a
strategy, 0.25 MiB fusion buckets.  The reference prints the collectives
its compiled step holds; the port has no compiled program, so this
prints the resolved ReduceSchedule IR: its per-bucket decomposition and
its stages by collective kind.  The latency is the IR's stage sum
(``ReduceSchedule.predicted_s``) under the reference's cost model,
whose constants model a TPU v5e, not the card.  Runs on CUDA (the ranks
share the card) unless ``--device cpu``.
"""
import argparse
import collections
import os
import tempfile

STRATEGIES = ["psum", "ring_rsa", "rhd_rsa", "ps_gather", "hierarchical",
              "auto"]
LABEL = {
    "psum": "vendor library (NCCL2 analogue)",
    "ring_rsa": "Baidu ring allreduce",
    "rhd_rsa": "paper's MPI-Opt (recursive halving/doubling)",
    "ps_gather": "gRPC parameter-server pattern",
    "hierarchical": "two-level intra/inter-pod (beyond paper)",
    "auto": "per-bucket selection (MVAPICH2-style tuning table)",
}
PODS, DATA, STEPS = 2, 4, 6


def _rank(rank, world, device):
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import AggregatorConfig
    from repro_torch.data.synthetic import SyntheticText
    from repro_torch.launch.mesh import make_groups
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

    if device != "cpu":
        torch.cuda.set_device(0)
    groups = make_groups(PODS, DATA)
    spec = get_spec("smollm-360m").reduced()
    model = build_model(spec)
    data = SyntheticText(spec.vocab_size, batch=8, seq_len=32)
    out = {}
    for strategy in STRATEGIES:
        trainer = Trainer(
            model, adamw(2e-3), data.batch_at,
            TrainerConfig(steps=STEPS, step=TrainStepConfig(
                aggregator=AggregatorConfig(strategy=strategy,
                                            fusion_threshold_mb=0.25),
                dp_axes=("pod", "data"))),
            device=device, verbose=False, groups=groups)
        module, _, history = trainer.run()
        sched = trainer.extras["aggregator"].last_schedule
        kinds = collections.Counter(st.hlo_kind or st.op
                                    for _p, _b, st in sched.iter_stages())
        big = sorted(sched.buckets, key=lambda b: -b.n_bytes)[:4]
        out[strategy] = {
            "losses": [h["loss"] for h in history],
            "render": sched.render(), "kinds": dict(kinds),
            "largest": [f"{b.n_bytes // 1024}KiB:{b.render()}" for b in big],
            "predicted_s": sched.predicted_s,
            "grad_bytes": sum(p.numel() * 4 for p in module.parameters()),
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo",
                    choices=("gloo", "cuda_ipc"))
    args = ap.parse_args()
    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import resolve_device
    device = str(resolve_device(args.device))
    world = PODS * DATA
    with tempfile.TemporaryDirectory() as rdv:
        res = run_ranks(_rank, world, (device,), backend=args.backend,
                        rendezvous_dir=rdv,
                        threads=max(1, (os.cpu_count() or 1) // world),
                        timeout_s=3600)[0]
    print(f"model: smollm-360m reduced, gradient volume "
          f"{res['psum']['grad_bytes'] / 2 ** 20:.1f} MiB, {PODS} pods x "
          f"{DATA} data ranks on {device} ({args.backend})\n")
    for strategy in STRATEGIES:
        r = res[strategy]
        print(f"{strategy:13s} | {LABEL[strategy]}")
        print(f"  losses: {['%.3f' % v for v in r['losses']]}")
        print(f"  schedule: {r['render']}")
        print(f"  stages by collective: {r['kinds']}")
        if strategy == "auto":
            print(f"  per-bucket selection: {r['largest']} ...")
        print(f"  cost-model allreduce latency (the reference's TPU v5e "
              f"constants): {r['predicted_s'] * 1e6:.0f} µs\n")


if __name__ == "__main__":
    main()
