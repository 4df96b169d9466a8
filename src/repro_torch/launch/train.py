"""End-to-end data-parallel training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --world 4 --backend gloo --steps 20 --batch 8 --seq 128 \\
        --strategy rhd_rsa --codec int8

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --mesh 2x2x1 --strategy ring_rsa×rhd_rsa --codec bf16×int8 ...

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --mesh 2x2 --strategy rhd_rsa ...      # data 2 × model 2

Spawns ``--world`` ranks with file rendezvous (``--world 1`` runs in
this process without ``torch.distributed``).  ``--mesh`` lays the ranks
out as the reference's mesh flag does: ``DxM`` (one data axis) or
``PxDxM`` (dp axes ``("pod", "data")``), pod major and model minor,
groups from ``launch/mesh.py``; a model axis ``M > 1`` holds the
parameters in shards (``core/manual.py``).  ``--world`` is the product
of the sizes (derived when omitted).  ``--backend gloo`` may put
several ranks on one card (payloads staged through host memory);
``--backend cuda_ipc`` too, with
the hop payloads kept in device memory (a gloo group carries control
messages only; ranks of one host); ``--backend nccl`` needs one card
per rank.  Runs on CUDA unless ``--device cpu``.  Keeps
``repro.launch.train``'s flags, except ``--host-devices`` (ranks are
processes); ``--ckpt-every N`` writes the full state (gathered on a
model axis) to ``--ckpt-dir`` every N steps from global rank 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split evenly over the ranks)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the mesh's product, else 1)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM, e.g. 4x1, 2x2 or 2x2x2")
    ap.add_argument("--backend", choices=("gloo", "nccl", "cuda_ipc"),
                    default="gloo")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--strategy", default="rhd_rsa")
    ap.add_argument("--codec", default="none")
    ap.add_argument("--fusion-mb", type=float, default=4.0)
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", choices=("adamw", "sgd"),
                    default="adamw")
    ap.add_argument("--full", action="store_true",
                    help="full (not reduced) architecture")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the spec's, bfloat16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut: the first N layers (default: the "
                         "spec's)")
    ap.add_argument("--mlstm-chunk", type=int, default=None,
                    help="xLSTM: the chunkwise mLSTM's chunk (default: the "
                         "spec's)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def mesh_shape(args) -> tuple[int, int, int]:
    """``(pods, data, model)`` of ``args.mesh`` (``pods = 0`` for
    ``DxM``; no mesh: one data axis of ``--world`` ranks).  Raises
    ValueError when ``--world`` disagrees with the mesh."""
    if args.mesh is None:
        return 0, args.world or 1, 1
    from repro_torch.launch.mesh import parse_mesh
    pods, data, model = parse_mesh(args.mesh)
    world = max(pods, 1) * data * model
    if args.world is not None and args.world != world:
        raise ValueError(f"--world {args.world} but --mesh {args.mesh} "
                         f"has {world} ranks")
    return pods, data, model


def aggregator_config(args):
    """The :class:`~repro_torch.core.AggregatorConfig` that ``args``
    describe."""
    from repro_torch.core import AggregatorConfig
    return AggregatorConfig(strategy=args.strategy, codec=args.codec,
                            fusion_threshold_mb=args.fusion_mb,
                            fuse=not args.no_fuse)


def build_trainer(args, verbose: bool = True, spec=None, aggregator=None,
                  groups=None, model=None):
    """The :class:`~repro_torch.train.Trainer` that ``args`` describe,
    for this rank (``groups``: the mesh's groups; a ``PxDxM`` mesh, or a
    ``DxM`` mesh with ``M > 1``, builds them through
    ``launch.mesh.make_groups`` when not given, a one-axis mesh defaults
    to the world group).  ``spec``, when
    given, is the model's :class:`~repro_torch.models.common.ModelSpec` as it is
    (a depth-cut or otherwise altered spec), in place of ``args.arch``,
    ``args.full``, ``args.dtype``, ``args.layers`` and
    ``args.mlstm_chunk``; ``aggregator``, an
    :class:`~repro_torch.core.AggregatorConfig` in place of
    :func:`aggregator_config`'s (``overlap=True``, for one); ``model``,
    a :class:`~repro_torch.models.ModelApi` in place of the spec's (its
    loss wrapped, for one; ``spec`` is then its spec).  None has a
    command-line flag."""
    from repro_torch.configs import get_spec
    from repro_torch.data.synthetic import SyntheticText, extra_inputs
    from repro_torch.launch.mesh import DP_AXES, make_groups
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup, sgd
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

    if model is not None:
        spec = model.spec
    elif spec is None:
        spec = get_spec(args.arch)
        if not args.full:
            spec = spec.reduced()
        if args.dtype:
            spec = dataclasses.replace(spec, dtype=args.dtype)
        if getattr(args, "layers", None):
            spec = dataclasses.replace(spec, num_layers=args.layers)
        if getattr(args, "mlstm_chunk", None):
            spec = dataclasses.replace(spec, mlstm_chunk=args.mlstm_chunk)
    data = SyntheticText(spec.vocab_size, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    extras = extra_inputs(spec, args.batch, seed=args.seed)

    def batch_at(step):
        return {**data.batch_at(step), **extras}

    lr = cosine_warmup(args.lr, max(args.steps // 20, 1), args.steps)
    opt = adamw(lr) if args.optimizer == "adamw" else sgd(lr)
    pods, data_size, model_size = mesh_shape(args)
    dp_axes = DP_AXES if pods else ("data",)
    if groups is None and (pods or model_size > 1):
        groups = make_groups(max(pods, 1), data_size, model_size)
        if not pods:
            del groups["pod"]
    cfg = TrainerConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        step=TrainStepConfig(aggregator=aggregator
                             or aggregator_config(args), dp_axes=dp_axes))
    return Trainer(model or build_model(spec), opt, batch_at, cfg,
                   device=args.device, verbose=verbose, groups=groups)


def _rank_main(rank: int, world: int, args):
    trainer = build_trainer(args, verbose=rank == 0)
    module, opt_state = trainer.init_state(args.seed)
    _, _, history = trainer.run(module=module, opt_state=opt_state)
    return history


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    pods, data, model = mesh_shape(args)
    world = max(pods, 1) * data * model
    print(f"arch={args.arch} world={world} mesh={args.mesh} "
          f"backend={args.backend} strategy={args.strategy} "
          f"codec={args.codec}", flush=True)
    if world == 1:
        history = _rank_main(0, 1, args)
    else:
        from repro_torch.core.dist import run_ranks
        with tempfile.TemporaryDirectory() as rdv:
            history = run_ranks(_rank_main, world, (args,),
                                backend=args.backend, rendezvous_dir=rdv,
                                threads=max(1, (os.cpu_count() or 1)
                                            // world),
                                timeout_s=24 * 3600)[0]
    final = history[-1]["loss"] if history else float("nan")
    print(f"final loss: {final:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
