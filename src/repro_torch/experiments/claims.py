"""Registry of the paper's quantitative claims (C-class anchors).

Counterpart of ``repro/experiments/claims.py``: the same ten claims,
bands, anchors and notes, evaluated on the port's matrix and cost
model, so every value equals the reference's.

Each claim binds ONE query against the characterization matrix (or the
micro-benchmark cost model it is built from) to the value our
reproduction produces, a tolerance band ``(lo, hi)`` that value must
stay inside, and the paper anchor it reproduces.  The bands are
REGRESSION bands on *our* reproduction — tight enough that changing any
constant the figure flows from (``core/hw.py``, the cost model, the
profiles) trips them, wide enough to absorb refactors that preserve the
physics.  Band-width rationale per claim class lives in the
reference's DESIGN.md §3.7; where our absolute number deviates from the
paper's, the deviation is stated in the claim's ``note`` instead of
being hidden by a wide band.

``tests/test_torch_experiments.py`` is the wall: every registered claim
must PASS on the cost-model backend, and ``regen.py`` re-emits the table
into ``artifacts_torch/EXPERIMENTS.md`` with per-claim PASS/FAIL.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..core import cost_model as cm

from . import matrix as mx


@dataclasses.dataclass(frozen=True)
class Claim:
    key: str                   # stable anchor, e.g. "C3_resnet50_eff_64"
    title: str
    anchor: str                # where the paper states it (Fig./Sec.)
    paper_value: str           # the paper's number, as text
    lo: float                  # tolerance band on OUR reproduction
    hi: float
    units: str
    fn: Callable[["Ctx"], float]
    note: str = ""             # deviation / interpretation notes

    def evaluate(self, ctx: "Ctx") -> dict:
        value = float(self.fn(ctx))
        return {
            "key": self.key, "title": self.title, "anchor": self.anchor,
            "paper_value": self.paper_value, "units": self.units,
            "value": value, "lo": self.lo, "hi": self.hi,
            "status": "PASS" if self.lo <= value <= self.hi else "FAIL",
            "note": self.note,
        }


class Ctx:
    """Shared, lazily-built matrix rows so evaluating the registry runs
    each grid once (claims are queries, not fresh experiments)."""

    def __init__(self):
        self._cache: dict = {}

    def rows(self, profile: str) -> list[dict]:
        key = ("scaling", profile)
        if key not in self._cache:
            self._cache[key] = mx.run_matrix(mx.grid(), profile=profile)
        return self._cache[key]

    def batch_rows(self, profile: str) -> list[dict]:
        key = ("batch", profile)
        if key not in self._cache:
            self._cache[key] = mx.run_matrix(
                mx.grid(designs=("Horovod_MPI_Opt",), models=("resnet50",),
                        workers=(1,), batches=mx.BATCHES), profile=profile)
        return self._cache[key]

    def efficiency(self, profile: str, model: str, p: int,
                   design: str = "Horovod_MPI_Opt") -> float:
        return mx.value(self.rows(profile), "efficiency", model=model,
                        p=p, design=design)

    def images_per_s(self, profile: str, model: str, p: int,
                     design: str) -> float:
        return mx.value(self.rows(profile), "images_per_s", model=model,
                        p=p, design=design)


# -- micro-benchmark helpers (Figs. 4-6 analogues) --------------------------

# The "paper" micro link is the scaling profile's (Piz Daint-class) link,
# NOT cost_model.PAPER_LINK — the micro and application claims must flow
# from the same constants the matrix uses.
PAPER_MICRO_LINK = mx.PROFILES["paper"].link


def _micro(link: cm.LinkParams, design: str, n_bytes: int,
           p: int = 16) -> float:
    fn = mx.design_latency_fn(design, p, _micro_profile(link))
    return fn(n_bytes)


def _micro_profile(link: cm.LinkParams) -> mx.HwProfile:
    # only .link / .grpc are read by design_latency_fn
    base = mx.PROFILES["v5e"]
    return dataclasses.replace(base, link=link, grpc=link)


def _vs_grpc(ctx: Ctx, model: str, p: int = 128) -> float:
    return ctx.images_per_s("paper", model, p, "Horovod_MPI_Opt") \
        / ctx.images_per_s("paper", model, p, "gRPC_PS")


def _ordering_margin(ctx: Ctx) -> float:
    nas = ctx.efficiency("paper", "nasnet-large", 64)
    r50 = ctx.efficiency("paper", "resnet50", 64)
    mbn = ctx.efficiency("paper", "mobilenet", 64)
    return min(nas - r50, r50 - mbn)


CLAIMS: tuple[Claim, ...] = (
    # ---- micro, paper link constants (validation profile) ----------------
    Claim(
        "C1_micro_small_vendor_gap",
        "MPI_Opt vs NCCL2 allreduce latency, 8 B, p=16 (paper link)",
        "Fig. 6 / abstract", "5x-17x (small/medium messages)",
        lo=4.0, hi=6.5, units="x",
        fn=lambda ctx: _micro(PAPER_MICRO_LINK, "Horovod_NCCL2", 8)
        / _micro(PAPER_MICRO_LINK, "Horovod_MPI_Opt", 8),
        note="our vendor baseline is a single software-alpha penalty "
             "(DESIGN.md D3): it reproduces the small-message regime and "
             "its direction, at the low end of the paper's 5-17x range"),
    Claim(
        "C2_micro_large_reduction",
        "MPI_Opt latency reduction vs default (host-staged) MPI, "
        "256 MiB, p=16 (paper link)",
        "Fig. 5/6 / abstract", "~29% (large messages)",
        lo=0.30, hi=0.40, units="fraction",
        fn=lambda ctx: 1.0
        - _micro(PAPER_MICRO_LINK, "Horovod_MPI_Opt", 256 << 20)
        / _micro(PAPER_MICRO_LINK, "Horovod_MPI", 256 << 20),
        note="slightly above the paper's 29%: our staging model charges "
             "full PCIe round-trips per step (DESIGN.md A1 mapping)"),
    # ---- application scaling, paper profile (Figs. 3/7/8/9) --------------
    Claim(
        "C3_resnet50_eff_64",
        "ResNet-50 scaling efficiency at p=64, Horovod_MPI_Opt",
        "Fig. 7 / Sec. VI-C", "~90%",
        lo=0.85, hi=0.95, units="fraction",
        fn=lambda ctx: ctx.efficiency("paper", "resnet50", 64)),
    Claim(
        "C4_resnet50_eff_16",
        "ResNet-50 scaling efficiency at p=16, Horovod_MPI_Opt",
        "Fig. 7", "~98%",
        lo=0.88, hi=0.98, units="fraction",
        fn=lambda ctx: ctx.efficiency("paper", "resnet50", 16),
        note="ours lands at ~0.93: the log2(p) straggler term "
             "(profile sync_s) bites earlier than the paper's cluster"),
    Claim(
        "C5_resnet50_vs_grpc_128",
        "ResNet-50 throughput, Horovod_MPI_Opt vs gRPC PS, p=128",
        "Fig. 9 / abstract", "1.8x",
        lo=1.6, hi=2.0, units="x",
        fn=lambda ctx: _vs_grpc(ctx, "resnet50")),
    Claim(
        "C6_mobilenet_vs_grpc_128",
        "MobileNet throughput, Horovod_MPI_Opt vs gRPC PS, p=128",
        "Fig. 9 / abstract", "3.2x",
        lo=1.4, hi=1.9, units="x",
        fn=lambda ctx: _vs_grpc(ctx, "mobilenet"),
        note="compressed vs the paper's 3.2x: our gRPC cost entry (A3) "
             "models transport alpha/beta only — no per-RPC "
             "serialization/framing, which is what murders many-small-"
             "tensor models on a real PS"),
    Claim(
        "C7_scaling_ordering",
        "Efficiency ordering at p=64: nasnet > resnet50 > mobilenet "
        "(min pairwise margin)",
        "Fig. 8 (0.92 > 0.71 > 0.16)", "ordering holds",
        lo=0.02, hi=0.35, units="fraction",
        fn=_ordering_margin,
        note="compute/comm ratio ordering — the paper's central "
             "characterization result"),
    # ---- TPU target (v5e), constants from core/hw.py ---------------------
    Claim(
        "C8_v5e_resnet50_eff_64",
        "ResNet-50 scaling efficiency at p=64 on the v5e profile",
        "Fig. 7 transposed (DESIGN.md A1)", "> paper's 90% (faster links)",
        lo=0.95, hi=0.995, units="fraction",
        fn=lambda ctx: ctx.efficiency("v5e", "resnet50", 64)),
    Claim(
        "C9_v5e_micro_default_staging_gap",
        "default (host-staged) MPI vs MPI_Opt, 1 MiB, p=16 (v5e link)",
        "Sec. V-A (staging removal)", "~8x at large messages",
        lo=7.0, hi=9.5, units="x",
        fn=lambda ctx: _micro(cm.ICI, "Horovod_MPI", 1 << 20)
        / _micro(cm.ICI, "Horovod_MPI_Opt", 1 << 20)),
    Claim(
        "C10_v5e_batch_amortization",
        "ResNet-50 per-device throughput, batch 64 vs 16, p=1 (v5e)",
        "Fig. 2 (sweet spot ~64)", "larger batch amortizes overhead",
        lo=1.05, hi=1.30, units="x",
        fn=lambda ctx: mx.value(ctx.batch_rows("v5e"), "images_per_s",
                                batch_per_dev=64)
        / mx.value(ctx.batch_rows("v5e"), "images_per_s",
                   batch_per_dev=16)),
)


def evaluate(claims: tuple[Claim, ...] = CLAIMS,
             ctx: Ctx | None = None) -> list[dict]:
    ctx = ctx or Ctx()
    out = [c.evaluate(ctx) for c in claims]
    keys = [r["key"] for r in out]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate claim keys: {keys}")
    return out
