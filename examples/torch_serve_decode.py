"""Batched serving on the port: prefill a batch of prompts on a data ×
model mesh of ranks and decode continuations with the KV-cache engine.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]

Counterpart of ``examples/serve_decode.py`` in ``repro_torch``: its
attention architecture (granite-3-2b) and its SSM architecture
(xlstm-350m, O(1) recurrent state) side by side.  4 ranks as data 2 ×
model 2: each
data rank prefills and decodes its 2 rows, the model ranks hold the
weights in shards.  Runs on CUDA (the ranks share the card) unless
``--device cpu``.
"""
import argparse
import os
import tempfile
import time


def _rank(rank, world, arch, device):
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import manual
    from repro_torch.data.synthetic import SyntheticText, extra_inputs
    from repro_torch.launch.mesh import make_groups
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    if device != "cpu":
        torch.cuda.set_device(0)
    groups = make_groups(1, 2, 2)
    del groups["pod"]
    spec = get_spec(arch).reduced()
    model = build_model(spec)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device).tree()
    mspecs = manual.model_shard_specs(params, groups["model"].size)
    params = manual.shard_params(params, mspecs, groups["model"])
    data = SyntheticText(spec.vocab_size, batch=4, seq_len=16)
    batch = {"tokens": data.batch_at(0)["tokens"], **extra_inputs(spec, 4)}
    engine = ServeEngine(model, params, groups,
                         ServeConfig(max_new_tokens=24, max_seq=48),
                         device=device)
    t0 = time.perf_counter()
    out = engine.generate(batch)
    return spec.family, out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo",
                    choices=("gloo", "cuda_ipc"))
    args = ap.parse_args()
    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import resolve_device
    device = str(resolve_device(args.device))
    for arch in ("granite-3-2b", "xlstm-350m"):
        with tempfile.TemporaryDirectory() as rdv:
            family, out, dt = run_ranks(
                _rank, 4, (arch, device), backend=args.backend,
                rendezvous_dir=rdv,
                threads=max(1, (os.cpu_count() or 1) // 4),
                timeout_s=3600)[0]
        n = out.shape[0] * out.shape[1]
        print(f"{arch:16s} ({family:6s}): batch {out.shape[0]} x "
              f"{out.shape[1]} new tokens in {dt:.1f}s "
              f"({n / dt:.1f} tok/s incl. step set-up)")
        print(f"  sample: {out[0][:12].tolist()}")


if __name__ == "__main__":
    main()
