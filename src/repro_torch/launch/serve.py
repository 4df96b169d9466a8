"""Serving launcher: batched greedy decode of synthetic prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 16 --new-tokens 32 --mesh 4x2

Counterpart of ``repro.launch.serve``, with its flags, plus
``--backend`` and ``--device`` as in ``launch/train.py``.  ``--mesh DxM``
or ``PxDxM`` lays ranks out through ``launch/mesh.py::make_groups`` and
spawns them (file rendezvous); ``--mesh 1x1`` runs in this process.  A
model axis ``M > 1`` holds the parameters in shards and gathers them at
every step.  Runs on CUDA unless ``--device cpu``.  Prints the
reference's two lines, then the prefill's seconds and decode's
milliseconds per token (from its second step on).
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mesh", default="4x2")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("gloo", "nccl", "cuda_ipc"),
                    default="gloo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def build_engine(args, spec=None):
    """``(engine, batch)`` that ``args`` describe, for this rank:
    parameters from a seeded generator on ``args.device`` (this rank's
    shards on a model axis), the synthetic prompts of ``--batch`` rows
    (with the VLM's image patches) and ``ServeConfig(max_seq=n_img +
    prompt_len + new_tokens + 1)``, ``n_img`` the patches' count (0
    without; the reference leaves them out, F8 in ROADMAP.md); the mesh's
    groups through ``make_groups`` when ``--mesh`` has more than one
    rank.  ``spec``, when given, is the model's spec as it is (no CLI
    flag), in place of ``args.arch`` and ``args.full``.  A
    ``seq_parallel`` spec is served as the reference serves it, outside
    the tensor-parallel path (``serve/step.py``): every rank holds the
    full weights."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import manual
    from repro_torch.data.synthetic import SyntheticText, extra_inputs
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import make_groups, parse_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    device = resolve_device(args.device)
    if spec is None:
        spec = get_spec(args.arch)
        if not args.full:
            spec = spec.reduced()
    pods, data, model_size = parse_mesh(args.mesh)
    groups = None
    if max(pods, 1) * data * model_size > 1:
        groups = make_groups(max(pods, 1), data, model_size)
        if not pods:
            del groups["pod"]
    model = build_model(spec)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device).tree()
    mgroup = (groups or {}).get(manual.MODEL_AXIS)
    if mgroup is not None and mgroup.size > 1 and not spec.seq_parallel:
        mspecs = manual.model_shard_specs(params, mgroup.size)
        params = manual.shard_params(params, mspecs, mgroup)
    data_src = SyntheticText(spec.vocab_size, batch=args.batch,
                             seq_len=args.prompt_len, seed=args.seed)
    batch = {"tokens": data_src.batch_at(0)["tokens"],
             **extra_inputs(spec, args.batch, seed=args.seed)}
    n_img = batch["patches"].shape[1] if "patches" in batch else 0
    cfg = ServeConfig(max_new_tokens=args.new_tokens,
                      max_seq=n_img + args.prompt_len + args.new_tokens + 1)
    return ServeEngine(model, params, groups, cfg, device), batch


def decode_ms(timing) -> float:
    """Median decode milliseconds per token from the second step on
    (the first, if it is the only one)."""
    steps = timing["decode_s"][1:] or timing["decode_s"]
    return statistics.median(steps) * 1e3 if steps else float("nan")


def _rank_main(rank: int, world: int, args):
    engine, batch = build_engine(args)
    t0 = time.perf_counter()
    out = engine.generate(batch)
    return out, time.perf_counter() - t0, engine.timing


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import parse_mesh
    resolve_device(args.device)      # no card: raise before any rank starts
    pods, data, model = parse_mesh(args.mesh)
    world = max(pods, 1) * data * model
    if world == 1:
        out, dt, timing = _rank_main(0, 1, args)
    else:
        from repro_torch.core.dist import run_ranks
        with tempfile.TemporaryDirectory() as rdv:
            out, dt, timing = run_ranks(
                _rank_main, world, (args,), backend=args.backend,
                rendezvous_dir=rdv,
                threads=max(1, (os.cpu_count() or 1) // world),
                timeout_s=24 * 3600)[0]
    total = out.shape[0] * out.shape[1]
    name = args.arch if args.full else f"{args.arch}-reduced"
    print(f"arch={name} generated {out.shape} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s incl. step set-up)")
    print("first row:", out[0][:16].tolist())
    print(f"prefill {timing['prefill_s']:.4f} s; decode "
          f"{decode_ms(timing):.3f} ms/token (median from step 2)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
