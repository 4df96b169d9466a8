"""Roofline terms of a step on the card, from counts taken on ``meta``.

Counterpart of ``repro/launch/roofline.py``.  The reference derives its
terms from a compiled step's ``cost_analysis`` and its HLO; the port
has neither, so it counts a step's work itself, on meta tensors (no
storage, nothing runs), and prices it with the card's data sheet
(``core/hw.py::H100_SXM``, never a TPU's):

    compute    = flops        / peak dense bf16 rate
    memory     = hbm_bytes    / HBM bandwidth
    collective = wire bytes   / NVLink bandwidth (each direction)

* **Operations**: ``torch.utils.flop_counter``'s formulas (what
  ``FlopCounterMode`` counts: the products) over the step (the loss and
  its backward for training; the prefill forward; one decode step) at
  one rank's rows.  On meta the kernel wrappers take their plain
  versions, which do the same products.
* **Bytes**: every aten op's operand and result bytes (views excluded),
  summed by the same ``TorchDispatchMode``: eager execution's traffic.  The
  hand-written kernels' fusions move less, so this bounds the memory
  term from above.
* **Activations** (training): the bytes autograd saves for backward,
  read by ``saved_tensors_hooks`` (each saved tensor once, the
  parameters themselves not): a kernel-backed ``autograd.Function``
  counts what its kernel saves (K7: q, k, v, O and the log-sum-exp;
  K6: x, its scale and rstd), not its plain version's temporaries.

A full-size step on meta still dispatches every op in Python, which at
full depth and sequence takes seconds a step.  :func:`count_step`
therefore counts small **probes** and extrapolates: every count is
affine in the rows from two rows on (one row is probed alone: some
reshapes are views only there), affine in the number of layers of each
kind, and a
polynomial of degree at most 2 in the sequence (attention's products are
quadratic, everything else linear), so a tensor grid of probes (rows 2
and 3; two or three depths; for the families whose op count grows with
the sequence, three sequences on the same code path) solves for it
exactly.  Attention is counted as one block (``attn_chunk`` = the
sequence): the same products as the plain version's blocks, without
their per-block bookkeeping.  MoE capacity is a ceiling of the token
count, so its expert products extrapolate to within that rounding.

``model_flops`` and ``active_params`` are the reference's, verbatim
(6·N·D training, 2·N·D inference), and ``useful_ratio`` keeps its
meaning: MODEL_FLOPS over every rank's counted flops.  The port's model
axis shards parameters but not compute (every model rank runs the whole
forward on its data rows, ``core/manual.py``), so on a model axis of m
the ratio is about 1/m of the data-parallel one.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import tree as tree_mod
from ..core import hw

# How the counts were taken: every record carries it.
METHOD = {
    "flops": "torch.utils.flop_counter's formulas (FlopCounterMode's) "
             "on meta tensors, one rank's rows",
    "bytes": "operand + result bytes of every aten op (views excluded) "
             "on meta: eager execution's traffic, an upper bound on the "
             "kernels' fused traffic",
    "activations": "saved_tensors_hooks on meta (each saved tensor once; "
                   "kernel-backed autograd Functions as their kernels "
                   "save)",
    "extrapolation": "probes at rows {2, 3} (or the one row), two or "
                     "three depths and, "
                     "where the op count grows with the sequence, three "
                     "sequences; solved as affine in rows and layer "
                     "counts and quadratic in the sequence",
    "collective": "the resolved ReduceSchedule's per-rank wire bytes "
                  "(training) or the serving step's all-gathers, over "
                  "NVLink",
}


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    chip: str = hw.H100_SXM.name
    method: dict = dataclasses.field(default_factory=lambda: dict(METHOD))

    def to_dict(self):
        return dataclasses.asdict(self)


def compute_roofline(flops: float, hbm_bytes: float,
                     collective_bytes: float, chips: int,
                     model_flops: float,
                     chip: hw.Gpu = hw.H100_SXM) -> Roofline:
    """The three terms of one rank's step (counts per rank)."""
    compute_s = flops / chip.peak_bf16_flops
    memory_s = hbm_bytes / chip.hbm_bandwidth
    collective_s = collective_bytes / chip.nvlink_bandwidth
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = flops * chips
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes, chips=chips,
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        chip=chip.name)


def step_estimate_s(roof: "Roofline",
                    exposed_collective_s: float | None = None) -> float:
    """Single-number step prediction from the roofline terms: the
    dominant on-chip term plus the collective term.  With
    ``exposed_collective_s`` (from an overlap Timeline) only the
    communication the backward could NOT hide is charged; ``None``
    charges the fully serialized collective term (the no-overlap
    baseline)."""
    coll = roof.collective_s if exposed_collective_s is None \
        else exposed_collective_s
    return max(roof.compute_s, roof.memory_s) + coll


def wire_check(sched, collective_bytes, rel_tol: float = 0.02) -> dict:
    """The wire check (rule HL001's comparison), from
    :mod:`repro_torch.analysis.hop_lint`, where it lives."""
    from ..analysis import hop_lint
    return hop_lint.wire_check(sched, collective_bytes, rel_tol=rel_tol)


def overlap_report(roof: "Roofline", timeline) -> dict:
    """Predicted overlap efficiency of a config: the timeline's hidden/
    exposed split rescaled to the roofline's collective term, plus
    serialized-vs-overlapped step predictions.  Hidden comm is capped at
    the backward span."""
    hidden = min(roof.collective_s * timeline.overlap_fraction,
                 timeline.backward_s)
    frac = hidden / roof.collective_s if roof.collective_s > 0 else 1.0
    exposed = roof.collective_s - hidden
    return {
        "overlap_fraction": frac,
        "hidden_comm_s": hidden,
        "exposed_comm_s": exposed,
        "step_serial_s": step_estimate_s(roof),
        "step_overlapped_s": step_estimate_s(roof,
                                             exposed_collective_s=exposed),
        "timeline": timeline.to_dict(),
    }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) per step
# ---------------------------------------------------------------------------

def active_params(spec) -> float:
    """Active parameter count (MoE counts top_k + shared experts only)."""
    total = 0.0
    if spec.num_experts:
        # replace expert bank with active experts
        per_expert = 3 * spec.d_model * spec.moe_d_ff
        n_moe_layers = spec.num_layers - spec.first_dense_layers
        total -= n_moe_layers * spec.num_experts * per_expert
        total += n_moe_layers * (spec.top_k
                                 + spec.num_shared_experts) * per_expert
    return total


def model_flops(spec, shape, params_total: float) -> float:
    """6·N·D for training, 2·N·D for inference forward/decode."""
    n = params_total + active_params(spec)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# counting on meta
# ---------------------------------------------------------------------------

_FREE_OPS = {"empty", "empty_like", "empty_strided", "detach", "alias",
             "lift_fresh", "_local_scalar_dense"}


class _Counter(TorchDispatchMode):
    """Flops (``FlopCounterMode``'s formulas, ``flop_registry``) and
    operand + result bytes of every aten op but views and allocations,
    in one pass."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.bincount.default:
            # No meta kernel (its size depends on the data): the MoE
            # load-balance count, whose bins the caller fixes with
            # ``minlength``.
            n = int(kwargs.get("minlength", args[2] if len(args) > 2
                               else 0))
            return torch.empty((n,), dtype=torch.int64, device="meta")
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func.overloadpacket.__name__ \
                not in _FREE_OPS:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


@dataclasses.dataclass(frozen=True)
class StepCounts:
    """One rank's step: ``flops``, ``bytes`` (aten traffic),
    ``saved_bytes`` (activations kept for backward), ``output_bytes``
    (what the step returns: the serving logits)."""
    flops: float
    bytes: float
    saved_bytes: float
    output_bytes: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _inputs(spec, kind: str, rows: int, seq: int) -> dict:
    """Meta inputs of one rank's step (``configs/base.input_specs``'
    layout at ``rows`` rows)."""
    i32 = torch.int32
    extra = {}
    if spec.family == "audio":
        extra["frames"] = _meta((rows, spec.encoder_seq, spec.d_model),
                                torch.bfloat16)
    if spec.family == "vlm" and kind != "decode":
        extra["patches"] = _meta((rows, spec.num_image_tokens,
                                  spec.d_model), torch.bfloat16)
    if kind == "train":
        return {"tokens": _meta((rows, seq), i32),
                "labels": _meta((rows, seq), i32), **extra}
    if kind == "prefill":
        return {"tokens": _meta((rows, seq), i32), **extra}
    return {"tokens": _meta((rows, 1), i32)}


def cache_len(spec, kind: str, seq: int) -> int:
    """The cache a serving step holds: ``seq`` positions, and for a
    prefill of the VLM its image patches too (``launch/serve.py`` sizes
    it so)."""
    if kind == "prefill" and spec.family == "vlm":
        return seq + spec.num_image_tokens
    return seq


def _tensor_bytes(x) -> int:
    leaves, _ = tree_flatten(x)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def probe(spec, kind: str, rows: int, seq: int) -> StepCounts:
    """Count one step of ``spec`` as it stands (no extrapolation)."""
    from ..models import build_model
    model = build_model(spec)
    params = model.init(torch.Generator().manual_seed(0), "meta").tree()
    batch = _inputs(spec, kind, rows, seq)
    saved: dict = {}
    param_ids = {id(p) for p in tree_mod.leaves(params)}

    def pack(t):
        if id(t) not in param_ids and id(t) not in saved:
            saved[id(t)] = t            # held: ids stay unique
        return t

    counter = _Counter()
    out_bytes = 0
    if kind == "train":
        for p in tree_mod.leaves(params):
            p.requires_grad_(True)
        with counter:
            with torch.autograd.graph.saved_tensors_hooks(pack,
                                                          lambda t: t):
                loss, _ = model.loss(params, batch)
            loss.backward()
    else:
        with torch.no_grad(), counter:
            if kind == "prefill":
                logits, _cache = model.prefill(params, batch,
                                               max_seq=cache_len(spec, kind,
                                                                 seq))
            else:
                cache = model.init_cache(rows, seq, device="meta")
                logits, _cache = model.decode_step(params, cache,
                                                   batch["tokens"])
        out_bytes = _tensor_bytes(logits)
    return StepCounts(
        flops=float(counter.flops), bytes=float(counter.bytes),
        saved_bytes=float(sum(t.numel() * t.element_size()
                              for t in saved.values())),
        output_bytes=float(out_bytes))


def _depth_design(spec):
    """``(probe overrides, their layer-kind features, the target's
    features)``: every count is affine in these features (the number of
    layers of each kind), so the probes are the smallest stacks that
    tell the kinds apart."""
    L = spec.num_layers
    if spec.family == "hybrid":
        # (Mamba2 layers, shared-attention applications); every probe
        # applies the shared block at least once, as the model does: its
        # second and later applications add to the shared weights'
        # gradients, which the first does not
        design = [{"num_layers": 1, "attn_every": 1},
                  {"num_layers": 2, "attn_every": 1},
                  {"num_layers": 2, "attn_every": 2}]
        return design, [(1, 1, 1), (1, 2, 2), (1, 2, 1)], \
            (1, L, L // spec.attn_every)
    if spec.family == "ssm":
        # (mLSTM blocks, sLSTM blocks)
        design = [{"num_layers": 1, "slstm_every": 0},
                  {"num_layers": 2, "slstm_every": 0},
                  {"num_layers": 2, "slstm_every": 2}]
        n_s = L // spec.slstm_every if spec.slstm_every else 0
        return design, [(1, 1, 0), (1, 2, 0), (1, 1, 1)], (1, L - n_s, n_s)
    if spec.family == "audio":
        # (encoder layers, decoder layers)
        design = [{"encoder_layers": e, "num_layers": d}
                  for e, d in ((1, 1), (2, 1), (1, 2))]
        feats = [(1, d["encoder_layers"], d["num_layers"]) for d in design]
        return design, feats, (1, spec.encoder_layers, L)
    # the transformer families: the dense prefix kept, the body grown
    p = spec.first_dense_layers
    design = [{"num_layers": p + n} for n in (1, 2)]
    return design, [(1, 1), (1, 2)], (1, L - p)


def _seq_design(spec, kind: str, seq: int):
    """``(probe sequences, spec overrides)``, or ``((seq,), {})`` when the
    op count does not grow with the sequence (attention as one block).
    Mamba2 loops over chunks (one chunk is a case of its own, so the
    probes hold two to four), the xLSTM over tokens (likewise from two
    on)."""
    probes = (seq,)
    if kind != "decode":
        if spec.family == "hybrid" and seq > 4 * spec.ssm_chunk:
            c = spec.ssm_chunk
            probes = (2 * c, 3 * c, 4 * c)
        elif spec.family == "ssm" and seq > 4:
            probes = (2, 3, 4)
    over = {}
    if probes != (seq,) and seq > spec.attn_full_seq_max:
        over["attn_full_seq_max"] = 0      # the probes take the flash path
    return probes, over


def _solve(points, values, target) -> float:
    """The value at ``target`` of the tensor-product polynomial through
    ``values`` at ``points`` (each a tuple of basis features)."""
    a = np.array(points, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, np.array(values, dtype=np.float64),
                               rcond=None)
    return float(np.dot(coef, np.array(target, dtype=np.float64)))


@functools.lru_cache(maxsize=256)
def _fit(spec, kind: str, seq: int, one_row: bool):
    depth, dfeats, dtarget = _depth_design(spec)
    seqs, over = _seq_design(spec, kind, seq)
    points, values = [], []
    # One row is a case of its own (some reshapes are views only there);
    # from two rows on, every count is affine in the rows.
    for rows in ((1,) if one_row else (2, 3)):
        for d, df in zip(depth, dfeats):
            for s in seqs:
                sp = dataclasses.replace(spec, **d, **over,
                                         attn_chunk=max(s, 1))
                c = probe(sp, kind, rows, s)
                sf = (1.0,) if len(seqs) == 1 else (1.0, s, s * s)
                points.append(tuple(r * f * g for r in (1.0, rows)
                                    for f in df for g in sf))
                values.append(dataclasses.astuple(c))
    return points, values, dtarget, len(seqs) > 1


def count_step(spec, kind: str, rows: int, seq: int) -> StepCounts:
    """One rank's step at ``rows`` rows and sequence ``seq`` (the cache
    length for decode), extrapolated exactly from probes (module
    docstring)."""
    points, values, dtarget, by_seq = _fit(spec, kind, seq, rows == 1)
    sf = (1.0, seq, seq * seq) if by_seq else (1.0,)
    target = tuple(r * f * g for r in (1.0, rows) for f in dtarget
                   for g in sf)
    cols = list(zip(*values))
    return StepCounts(*(max(0.0, round(_solve(points, col, target)))
                        for col in cols))


__all__ = ["METHOD", "Roofline", "StepCounts", "active_params",
           "compute_roofline", "count_step", "model_flops",
           "overlap_report", "probe", "step_estimate_s", "wire_check"]

