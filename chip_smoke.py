#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and excused):

1. Build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once.
2. Hold each kernel against its plain torch version on the card — at a
   1 Mi-element bucket, a ragged n and the largest main-path hop —
   bit for bit (K5: within 1 ulp), plus the subnormal regime against
   the plain version on a CPU copy under the flush-to-zero guard, and
   e4m3 values that round up to exactly 448.  Times each kernel, its
   plain version and, where one exists, one PyTorch call computing the
   same function (a yardstick the port never calls).
3. Train full-width smollm-360m (32 layers, d_model 960, ~362 M
   parameters, bf16 compute) on 4 ranks sharing this card over gloo,
   batch 2 per rank, seq 512, ``rhd_rsa`` + ``int8`` fused hops and the
   K5 AdamW, for 3 steps through ``Trainer``.  Every launch count is
   reset just before and read just after; every kernel must have run,
   losses must be finite and parameters bit-identical on every rank.
   Then the same 4 ranks train a small float32 model twice, on the card
   and on the host's plain versions, and the two must agree.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": ...}``.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TRAIN_WORLD = 4
TRAIN_STEPS = 3
CHECK_N = 1 << 20            # a main-path bucket size (1 Mi f32)
RAGGED_N = 1_000_003
HOP_SHAPE = (16, 960, 2560)  # first RHD hop of the d_ff bucket at p=4
LEAF_SHAPE = (32, 960, 2560)  # the largest parameter leaf (body/mlp/w1)


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_flops):
    from repro_torch.core.hw import H100_SXM
    t_bytes = n_bytes / H100_SXM.hbm_bandwidth
    t_ops = n_flops / H100_SXM.peak_f32_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def bits_equal(a, b):
    import torch
    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.element_size() == 1:
        return torch.equal(a.view(torch.uint8).cpu(), b.view(torch.uint8).cpu())
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view).cpu(), b.view(view).cpu())


def max_abs(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def max_ulp(a, b):
    import torch

    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def require(cond, what):
    if not cond:
        raise AssertionError(what)


MAX_ERR = {"hop_absmax": 0.0, "hop_encode": 0.0, "hop_decode_add": 0.0,
           "adamw_update": 0.0}


def agree(key, a, b, what):
    """Require bit equality of a kernel's output with its plain version
    and record the largest absolute difference seen for the kernel."""
    if a is not None and b is not None:
        MAX_ERR[key] = max(MAX_ERR[key], max_abs(a, b))
    require(bits_equal(a, b), what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sample(n, gen, device, outliers=True):
    import torch
    x = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    if outliers:
        x[:: max(n // 97, 1)] *= 300.0
    return x


def check_hop_kernels(gen):
    import torch
    from repro_torch.kernels import fused_hop as fh
    cuda = torch.device("cuda")
    for n in (CHECK_N, RAGGED_N, math.prod(HOP_SHAPE)):
        x = sample(n, gen, cuda)
        agree("hop_absmax", fh.hop_absmax(x), fh.absmax_plain(x),
              f"K1 hop_absmax != plain at n={n}")
        add = sample(n, gen, cuda, outliers=False)
        for name in ("bf16", "int8", "fp8_e4m3"):
            (p, s), (pp, sp) = fh.hop_encode(name, x), fh.encode_plain(name, x)
            agree("hop_encode", p, pp, f"K2 hop_encode[{name}] payload != "
                                       f"plain at n={n}")
            agree("hop_encode", s, sp, f"K2 hop_encode[{name}] scale != "
                                       f"plain at n={n}")
            for a_ in (add, None):
                agree("hop_decode_add", fh.hop_decode_add(name, p, s, a_),
                      fh.decode_add_plain(name, p, s, a_),
                      f"K3 hop_decode_add[{name}, add={a_ is not None}] != "
                      f"plain at n={n}")
        agree("hop_decode_add", fh.hop_decode_add("none", x, None, add),
              fh.decode_add_plain("none", x, None, add),
              f"K3 hop_decode_add[none+add] != plain at n={n}")
        log(f"  K1/K2/K3 bit-exact vs plain at n={n} "
            f"(bf16, int8, fp8_e4m3; scaled x add variants)")

    # e4m3 near the top of the range: absmax 448 gives scale 1, so the
    # payload is the cast itself; 432 and 440 round up to exactly 448.
    edge = torch.tensor([448.0, -448.0, 447.9, 440.0, 432.0, -432.0,
                         431.9, 416.0, 0.001953125, -0.0, 1e-3], device=cuda)
    p, s = fh.hop_encode("fp8_e4m3", edge)
    pc, sc = fh.encode_plain("fp8_e4m3", edge.cpu())
    agree("hop_encode", p, pc, "K2 fp8 edge values differ from the CPU cast")
    agree("hop_encode", s, sc, "K2 fp8 edge scale differs from the CPU")
    require(float(p.float()[4]) == 448.0, "432 must round up to 448")
    log("  K2 fp8 edge values (round-up to 448, ties to even) match the "
        "CPU cast")

    # Subnormal regime: the card's kernels against the plain versions on
    # a CPU copy under the flush-to-zero guard (the reference's FTZ).
    cases = {
        "subnormal absmax": torch.full((4096,), 4.4e-39) *
        torch.sign(torch.randn(4096, generator=torch.Generator()
                               .manual_seed(1))),
        "normal absmax, subnormal elements": torch.cat([
            torch.tensor([3.9e-37]), torch.full((4095,), 8e-39)]),
        "tiny-clamped scale": torch.linspace(-1e-36, 1e-36, 4096),
    }
    for label, xc in cases.items():
        xc = xc.to(torch.float32)
        xg = xc.to(cuda)
        agree("hop_absmax", fh.hop_absmax(xg), fh.absmax_plain(xc),
              f"K1 subnormal case {label!r}")
        for name in ("int8", "fp8_e4m3"):
            (p, s), (pc, sc) = fh.hop_encode(name, xg), \
                fh.encode_plain(name, xc)
            agree("hop_encode", p, pc, f"K2[{name}] subnormal {label!r}")
            agree("hop_encode", s, sc, f"K2[{name}] subnormal {label!r}")
            agree("hop_decode_add", fh.hop_decode_add(name, p, s, xg),
                  fh.decode_add_plain(name, pc, sc, xc),
                  f"K3[{name}] subnormal case {label!r}")
        # bf16 keeps subnormals (a cast, no arithmetic); the accumulate
        # flushes them.  The CPU's own f32->bf16 instruction may flush
        # on some hosts, so the decode side is held on one payload.
        p, _ = fh.hop_encode("bf16", xg)
        agree("hop_decode_add", fh.hop_decode_add("bf16", p, None, xg),
              fh.decode_add_plain("bf16", p.cpu(), None, xc),
              f"K3[bf16] subnormal case {label!r}")
    _, s = fh.hop_encode("int8", cases["subnormal absmax"].to(cuda))
    require(float(s) == float(torch.tensor(1.0) / 127.0),
            "subnormal absmax must flush: scale 1/127")
    log("  subnormal regime bit-exact vs plain on the CPU under FTZ "
        "(absmax 4.4e-39 -> scale 1/127)")


def check_adamw(gen):
    import torch
    from repro_torch.kernels import fused_adamw as fa
    cuda = torch.device("cuda")
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              count=3)
    for n in (CHECK_N, RAGGED_N, math.prod(LEAF_SHAPE)):
        p = sample(n, gen, cuda, outliers=False) * 0.05
        g = sample(n, gen, cuda) * 1e-3
        m = sample(n, gen, cuda, outliers=False) * 1e-4
        v = sample(n, gen, cuda, outliers=False).square() * 1e-6
        out = fa.adamw_update(p, g, m, v, **kw)
        ref = fa.adamw_update_plain(p, g, m, v, **kw)
        ulps = [max_ulp(a, b) for a, b in zip(out, ref)]
        MAX_ERR["adamw_update"] = max(MAX_ERR["adamw_update"],
                                      *(max_abs(a, b)
                                        for a, b in zip(out, ref)))
        require(max(ulps) <= 1, f"K5 adamw_update off by {ulps} ulp at n={n}")
        log(f"  K5 adamw_update vs plain at n={n}: max ulp (p, m, v) = "
            f"{ulps}")


def measure(gen):
    """Per-kernel times at the main path's largest shapes."""
    import torch
    from repro_torch.kernels import fused_adamw as fa, fused_hop as fh
    cuda = torch.device("cuda")
    n = math.prod(HOP_SHAPE)
    x = sample(n, gen, cuda).reshape(HOP_SHAPE)
    add = sample(n, gen, cuda, outliers=False).reshape(HOP_SHAPE)
    payload, scale = fh.hop_encode("int8", x)
    scale_f = float(scale)
    rows = {}

    def row(key, fn, plain, library, n_bytes, n_flops, replaces, what):
        ms = time_ms(fn)
        b_ms, by = bound_ms(n_bytes, n_flops)
        rows[key] = {"ms": ms, "plain_ms": time_ms(plain),
                     "library_ms": time_ms(library) if library else None,
                     "bound_ms": b_ms, "bound_by": by, "replaces": replaces}
        log(f"  {key:15s} {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{by}, plain {rows[key]['plain_ms']:.4f} ms, library "
            f"{rows[key]['library_ms']})")

    row("hop_absmax", lambda: fh.hop_absmax(x), lambda: fh.absmax_plain(x),
        lambda: x.abs().amax(), 4 * n, 2 * n,
        "src/repro/kernels/fused_hop.py:144", f"f32 {HOP_SHAPE}")
    row("hop_encode", lambda: fh.hop_encode("int8", x),
        lambda: fh.encode_plain("int8", x), None, 4 * n + n + 4, 6 * n,
        "src/repro/kernels/fused_hop.py:153",
        f"int8 {HOP_SHAPE} (absmax + quantize)")
    row("hop_decode_add", lambda: fh.hop_decode_add("int8", payload, scale,
                                                      add),
        lambda: fh.decode_add_plain("int8", payload, scale, add),
        lambda: torch.add(add, payload, alpha=scale_f), n + 4 * n + 4 * n,
        2 * n, "src/repro/kernels/fused_hop.py:164",
        f"int8*scale+add {HOP_SHAPE}")
    del x, add, payload
    nl = math.prod(LEAF_SHAPE)
    p = sample(nl, gen, cuda, outliers=False) * 0.05
    g = sample(nl, gen, cuda) * 1e-3
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, count=1)
    library = None
    if hasattr(torch, "_fused_adamw_"):
        step = [torch.ones((), device=cuda)]

        def library():
            torch._fused_adamw_([p], [g], [m], [v], [], step, lr=1e-3,
                                beta1=0.9, beta2=0.95, weight_decay=0.1,
                                eps=1e-8, amsgrad=False, maximize=False)
    row("adamw_update", lambda: fa.adamw_update(p, g, m, v, inplace=True,
                                                  **kw),
        lambda: fa.adamw_update_plain(p, g, m, v, **kw), library,
        16 * nl + 12 * nl, 15 * nl, "src/repro/kernels/fused_adamw.py:21",
        f"f32 in place {LEAF_SHAPE}")
    del p, g, m, v
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path on 4 ranks
# ---------------------------------------------------------------------------

def train_args(**over):
    from repro_torch.launch.train import parser
    base = ["--arch", "smollm-360m", "--steps", str(TRAIN_STEPS),
            "--strategy", "rhd_rsa", "--codec", "int8", "--lr", "1e-3",
            "--log-every", "1"]
    args = parser().parse_args(base)
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _counts():
    from repro_torch.kernels import fused_adamw as fa, fused_hop as fh
    return {"hop_absmax": fh.hop_absmax.launches,
            "hop_encode": fh.hop_encode.launches,
            "hop_decode_add": fh.hop_decode_add.launches,
            "adamw_update": fa.adamw_update.launches}


def _reset_counts():
    from repro_torch.kernels import fused_adamw as fa, fused_hop as fh
    for fn in (fh.hop_absmax, fh.hop_encode, fh.hop_decode_add,
               fa.adamw_update):
        fn.launches = 0


def _checksum(params):
    import torch
    from repro_torch import tree
    total = 0
    for p in tree.leaves(params):
        total += int(p.detach().view(torch.int32).to(torch.int64).sum())
    return total


def _step_breakdown(trainer, module, args):
    """Host-clock seconds of the step's layers, each timed alone after
    the main path (synchronised before and after): forward+backward on
    this rank's shard, the aggregation of the full gradient tree, and
    the optimizer update."""
    import torch
    from repro_torch import tree
    from repro_torch.models import param_groups
    from repro_torch.train.step import shard_batch

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    params = module.tree()
    agg = trainer.extras["aggregator"]
    batch = {k: v.to(args.device) for k, v in shard_batch(
        trainer.data_iter_fn(TRAIN_STEPS), agg.groups["data"]).items()}

    def fwd_bwd():
        loss, _ = trainer.model.loss(params, batch)
        loss.backward()
        return tree.tree_map(lambda p: p.grad, params)

    t_fb, grads = timed(fwd_bwd)
    t_agg, reduced = timed(lambda: agg(grads, groups=param_groups(params)))
    state = trainer.optimizer.init(params)
    t_opt, _ = timed(lambda: trainer.optimizer.update(reduced, state,
                                                      params))
    for p in tree.leaves(params):
        p.grad = None
    return {"fwd_bwd_s": t_fb, "aggregate_s": t_agg, "optimizer_s": t_opt}


def train_rank(rank, world, args, small_args):
    import torch
    from repro_torch import tree
    from repro_torch.core import Group
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.transformer import TransformerLM

    if args.device == "cuda":
        torch.cuda.set_device(0)
    group = Group()
    trainer = build_trainer(args, group=group, verbose=False)
    module, opt_state = trainer.init_state(args.seed)
    n_params = sum(p.numel() for p in module.parameters())
    steps = []
    _reset_counts()                           # main path starts here
    for s in range(TRAIN_STEPS):
        before = _counts()
        module, opt_state, hist = trainer.run(1, module, opt_state,
                                              start_step=s)
        after = _counts()
        steps.append({**hist[0], "launches": {k: after[k] - before[k]
                                              for k in after}})
    totals = _counts()                        # main path ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if args.device == "cuda" else 0.0
    checksum = _checksum(module.tree())
    breakdown = _step_breakdown(trainer, module, args)
    del module, opt_state, trainer

    # Small reference check: the same step on the card and on the host's
    # plain versions, from one initialisation, must agree.
    losses, finals = {}, {}
    init = None
    for device in ("cpu", args.device):
        small = build_trainer(argparse.Namespace(**{**vars(small_args),
                                                    "device": device}),
                              group=group, verbose=False)
        if init is None:
            init = small.init_state(small_args.seed)[0].tree()
        mod = TransformerLM(small.model.spec, tree.tree_map(
            lambda t: t.detach().clone().to(device), init))
        mod, _, hist = small.run(small_args.steps, mod,
                                 small.optimizer.init(mod.tree()))
        losses[device] = [h["loss"] for h in hist]
        finals[device] = tree.leaves(mod.tree())
    param_diff = max(float((a.detach().cpu() - b.detach().cpu()).abs().max())
                     for a, b in zip(finals["cpu"], finals[args.device]))
    return {"rank": rank, "n_params": n_params, "steps": steps,
            "breakdown": breakdown,
            "totals": totals, "checksum": checksum, "peak_gib": peak_gib,
            "small_losses": losses, "small_param_diff": param_diff}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core.dist import run_ranks
    from repro_torch.kernels import backend

    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("phase 1: build")
    t0 = time.perf_counter()
    reports = backend.build_all()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_hop_kernels(gen)
    check_adamw(gen)
    rows = measure(gen)

    log("phase 3: train full-width smollm-360m")
    log(f"transport: gloo, {TRAIN_WORLD} ranks on one card, CUDA payloads "
        f"staged through host memory explicitly in ppermute")
    args = train_args(full=True, batch=2 * TRAIN_WORLD, seq=512,
                      device="cuda")
    small = train_args(full=False, batch=2 * TRAIN_WORLD, seq=32, steps=2,
                       dtype="float32")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(train_rank, TRAIN_WORLD, (args, small),
                            backend="gloo", rendezvous_dir=rdv,
                            threads=max(1, (os.cpu_count() or 1)
                                        // TRAIN_WORLD),
                            timeout_s=900)
    log(f"  {TRAIN_WORLD} ranks done in {time.perf_counter() - t0:.1f} s; "
        f"{results[0]['n_params']} parameters per replica; peak "
        f"{max(r['peak_gib'] for r in results):.2f} GiB per rank")
    for s, rec in enumerate(results[0]["steps"]):
        log(f"  step {s + 1}: loss {rec['loss']:.5f} grad_norm "
            f"{rec['grad_norm']:.5f} step_s {rec['step_s']:.3f} buckets "
            f"{rec['n_buckets']} launches/rank {rec['launches']}")
    for r in results:
        log(f"  rank {r['rank']} layers, one step timed alone after the "
            f"main path: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      r["breakdown"].items()))
    for r in results:
        require(all(v > 0 for v in r["totals"].values()),
                f"rank {r['rank']}: a kernel never launched {r['totals']}")
        require(all(math.isfinite(rec["loss"]) for rec in r["steps"]),
                f"rank {r['rank']}: non-finite loss")
    sums = {r["checksum"] for r in results}
    require(len(sums) == 1, f"parameters differ across ranks: {sums}")
    log(f"  parameters bit-identical on all {TRAIN_WORLD} ranks "
        f"(checksum {sums.pop()})")
    sl = results[0]["small_losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(sl["cpu"], sl[args.device]))
    log(f"  small float32 model, card vs host plain versions: losses "
        f"{sl[args.device]} vs {sl['cpu']} (max rel {rel:.2e}), max param diff "
        f"{results[0]['small_param_diff']:.2e}")
    require(rel <= 1e-3, "card and host training disagree")

    launches = {k: sum(r["totals"][k] for r in results)
                for k in results[0]["totals"]}
    record = {"kernels": [
        {"name": k, "route": "cuda",
         "source": ("src/repro_torch/kernels/csrc/fused_adamw.cu"
                    if k == "adamw_update"
                    else "src/repro_torch/kernels/csrc/fused_hop.cu"),
         "replaces": rows[k]["replaces"], "launches": launches[k],
         "max_abs_err": MAX_ERR[k], "ms": rows[k]["ms"],
         "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
         "bound_by": rows[k]["bound_by"],
         "library_ms": rows[k]["library_ms"]}
        for k in ("hop_absmax", "hop_encode", "hop_decode_add",
                  "adamw_update")]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
