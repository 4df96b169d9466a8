"""End-to-end training on the port: a ~100M-parameter SmolLM-family
model trained for a few hundred steps on synthetic data, with
checkpoints and the full distributed stack (rhd_rsa + fusion + cache).

    PYTHONPATH=src python examples/torch_train_lm.py --preset quick
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

Counterpart of ``examples/train_lm.py`` in ``repro_torch``: 8 ranks laid
out as data 4 × model 2; the full state (parameters and AdamW moments,
gathered over the model axis) is saved every ``steps // 2`` steps by
rank 0, in the reference's checkpoint format.  Runs on CUDA (the ranks
share the card) unless ``--device cpu``.  (The production path is
``python -m repro_torch.launch.train --arch <id> --full``.)
"""
import argparse
import dataclasses
import os
import tempfile

PRESETS = {
    # ~100M-class (72M actual): 12L d=512 ff=2048 vocab=49152 (tied)
    "100m": dict(num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
                 d_ff=2048, steps=200, batch=8, seq=64),
    "quick": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                  d_ff=1024, steps=60, batch=8, seq=64),
}


def _spec(p):
    from repro_torch.configs import get_spec
    return dataclasses.replace(
        get_spec("smollm-360m"),
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        d_ff=p["d_ff"], attn_full_seq_max=max(p["seq"], 256))


def _rank(rank, world, p, steps, ckpt_dir, device):
    import torch

    from repro_torch.core import AggregatorConfig
    from repro_torch.data.synthetic import SyntheticText
    from repro_torch.launch.mesh import make_groups
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

    if device != "cpu":
        torch.cuda.set_device(0)
    groups = make_groups(1, 4, 2)
    del groups["pod"]
    spec = _spec(p)
    data = SyntheticText(spec.vocab_size, batch=p["batch"], seq_len=p["seq"])
    opt = adamw(cosine_warmup(3e-3, steps // 10, steps))
    trainer = Trainer(
        build_model(spec), opt, data.batch_at,
        TrainerConfig(steps=steps, log_every=max(steps // 20, 1),
                      ckpt_every=steps // 2, ckpt_dir=ckpt_dir,
                      step=TrainStepConfig(
                          aggregator=AggregatorConfig(
                              strategy="rhd_rsa", fusion_threshold_mb=4.0),
                          dp_axes=("data",))),
        device=device, verbose=rank == 0, groups=groups)
    _, _, history = trainer.run()
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="quick")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo",
                    choices=("gloo", "cuda_ipc"))
    args = ap.parse_args()
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]

    import torch

    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import resolve_device
    from repro_torch.models import build_model
    device = str(resolve_device(args.device))
    module = build_model(_spec(p)).init(torch.Generator(), "meta")
    n = sum(x.numel() for x in module.parameters())
    print(f"params: {n / 1e6:.1f}M  steps: {steps}")
    with tempfile.TemporaryDirectory() as rdv:
        history = run_ranks(_rank, 8, (p, steps, args.ckpt_dir, device),
                            backend=args.backend, rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1) // 8),
                            timeout_s=24 * 3600)[0]
    first, last = history[0]["loss"], history[-1]["loss"]
    mean_s = sum(h["step_s"] for h in history[1:]) / max(len(history) - 1, 1)
    print(f"\nloss {first:.3f} -> {last:.3f} ({mean_s * 1e3:.0f} ms a step "
          f"after the first; checkpoints in {args.ckpt_dir})")
    assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
