"""Quickstart on the port: train a tiny assigned-architecture model with
the paper's gradient-aggregation stack, then decode from it.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch smollm-360m]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Counterpart of ``examples/quickstart.py`` in ``repro_torch``: 4 ranks
laid out as data 2 × model 2 (``launch.mesh.make_groups``); the data
axis runs the explicit recursive-halving/doubling allreduce (the paper's
MPI-Opt design) with tensor fusion and the plan cache, the model axis
holds the parameters in shards.  The same ranks then serve the trained
shards with ``ServeEngine`` (the gather boundary rebuilds the weights at
every step).  Runs on CUDA (the ranks share the card) unless
``--device cpu``.
"""
import argparse
import os
import tempfile


def _rank(rank, world, args):
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import AggregatorConfig
    from repro_torch.core.plan_cache import GLOBAL_PLAN_CACHE
    from repro_torch.data.synthetic import SyntheticText, extra_inputs
    from repro_torch.launch.mesh import make_groups
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

    if args.device != "cpu":
        torch.cuda.set_device(0)
    groups = make_groups(1, 2, 2)
    del groups["pod"]
    spec = get_spec(args.arch).reduced()
    model = build_model(spec)
    if rank == 0:
        print(f"== {spec.name} ({spec.family}) on data 2 x model 2 ==",
              flush=True)
    data = SyntheticText(spec.vocab_size, batch=8, seq_len=64)
    extras = extra_inputs(spec, 8)
    opt = adamw(cosine_warmup(2e-3, 5, args.steps))
    trainer = Trainer(
        model, opt, lambda step: {**data.batch_at(step), **extras},
        TrainerConfig(steps=args.steps, log_every=10,
                      step=TrainStepConfig(
                          aggregator=AggregatorConfig(
                              strategy="rhd_rsa", fusion_threshold_mb=1.0),
                          dp_axes=("data",))),
        device=args.device, verbose=rank == 0, groups=groups)
    module, _, _ = trainer.run()
    stats = GLOBAL_PLAN_CACHE.stats()

    engine = ServeEngine(model, module.tree(), groups,
                         ServeConfig(max_new_tokens=16, max_seq=96),
                         device=args.device)
    prompt = data.batch_at(999)["tokens"][:2, :16]
    out = engine.generate({"tokens": prompt, **extra_inputs(spec, 2)})
    return stats, prompt[0][:8].tolist(), out[0].tolist()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo",
                    choices=("gloo", "cuda_ipc"))
    args = ap.parse_args()
    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import resolve_device
    args.device = str(resolve_device(args.device))
    with tempfile.TemporaryDirectory() as rdv:
        stats, prompt, decoded = run_ranks(
            _rank, 4, (args,), backend=args.backend, rendezvous_dir=rdv,
            threads=max(1, (os.cpu_count() or 1) // 4), timeout_s=3600)[0]
    print(f"plan cache: {stats}")
    print("prompt :", prompt)
    print("decoded:", decoded)


if __name__ == "__main__":
    main()
