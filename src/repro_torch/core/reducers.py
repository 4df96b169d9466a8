"""Allreduce algorithms over process groups.

Counterpart of ``repro/core/reducers.py``: each reducer is an explicit
collective algorithm built from point-to-point ``ppermute`` hops
(``core/dist.py``), so the communication schedule is exactly the one
written here.  All reducers compute an elementwise SUM over the group and
chunk along the leading dim (padding as needed), as the reference does.

``psum``       ``dist.all_reduce`` (the vendor baseline, NCCL2's analogue)
``ring_rsa``   ring reduce-scatter + ring allgather
``rhd_rsa``    recursive vector halving/doubling — the paper's design,
               with MVAPICH2's pre/post fold for non-power-of-two p
``ps_gather``  all-gather + local reduce (the parameter-server pattern);
               fused, the reduce is kernel K4
``hierarchical``  two levels (pod × data), the stages of ``ring_rsa×rhd_rsa``
               (:func:`allreduce`): ring reduce-scatter inside the pod,
               ``rhd_rsa`` of the 1/d chunk across pods, ring all-gather
               inside the pod

A reducer's ``axis`` is a :class:`~repro_torch.core.dist.Group`.
"""
from __future__ import annotations

import torch

from ..kernels.fused_reduce import fused_reduce
from ..telemetry import trace as telemetry_trace
from . import dist as dist_mod
from .dist import all_gather, axis_index, axis_size, ppermute

STRATEGIES = ("psum", "ring_rsa", "rhd_rsa", "ps_gather", "hierarchical")

# Algorithms whose accumulate can route through the fused hop kernels.
FUSED_HOP_ALGORITHMS = ("ring_rsa", "rhd_rsa", "ps_gather")


def _as_hop(permute):
    """Adapt a hop primitive to ``hop(x, group, perm, add=None,
    keep_sent=False, blocks=1)``: returns ``recv`` (or ``add + recv``),
    and with ``keep_sent`` the pair ``(recv, sent)`` where ``sent`` is
    what the receivers decode of ``x`` (``x`` itself on an uncoded
    wire).  ``blocks`` is the number of equal blocks along dim 0 that
    a coded wire scales each on its own (see ``core/codec.py``)."""
    if getattr(permute, "supports_add", False):
        return permute

    def hop(x, group, perm, add=None, keep_sent=False, blocks=1):
        r = permute(x, group, perm)
        r = r if add is None else add + r
        return (r, x) if keep_sent else r

    return hop


def _pow2_core(p: int) -> int:
    """Largest power of two <= p: the size of the RHD core group."""
    return 1 << (p.bit_length() - 1)


def _pad_leading(x: torch.Tensor, multiple: int):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x, n


def _ring_perm(p: int):
    return [(i, (i + 1) % p) for i in range(p)]


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    return dist_mod.psum(x, axis)


def ring_reduce_scatter(x: torch.Tensor, axis, permute=ppermute):
    """Ring reduce-scatter along the leading dim: returns ``(chunk,
    orig_len)``; rank ``i`` owns chunk ``(i + 1) % p``."""
    p = axis_size(axis)
    x, n = _pad_leading(x, p)
    if p == 1:
        return x, n
    idx = axis_index(axis)
    perm = _ring_perm(p)
    hop = _as_hop(permute)
    cl = x.shape[0] // p

    def chunk_at(i):
        return x[i * cl:(i + 1) * cl]

    buf = chunk_at(idx)
    for s in range(1, p):
        buf = hop(buf, axis, perm, add=chunk_at((idx - s) % p))
    return buf, n


def ring_all_gather(chunk: torch.Tensor, axis, orig_len: int,
                    permute=ppermute) -> torch.Tensor:
    """Inverse of :func:`ring_reduce_scatter`.  Each rank stores the
    value it forwarded (what its successor received), so on a coded wire
    the owner of a chunk holds the decoded copy its peers hold — exactly,
    whenever re-encoding an already-decoded chunk is the identity."""
    p = axis_size(axis)
    if p == 1:
        return chunk[:orig_len]
    idx = axis_index(axis)
    perm = _ring_perm(p)
    hop = _as_hop(permute)
    out = chunk.new_zeros((p,) + tuple(chunk.shape))
    cur = chunk
    for s in range(p):
        slot = (idx - s + 1) % p
        if s != p - 1:
            cur, out[slot] = hop(cur, axis, perm, keep_sent=True)
        else:
            out[slot] = cur
    out = out.reshape((p * chunk.shape[0],) + tuple(chunk.shape[1:]))
    return out[:orig_len]


def ring_rsa(x: torch.Tensor, axis, permute=ppermute) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce: 2(p-1) steps."""
    chunk, n = ring_reduce_scatter(x, axis, permute=permute)
    return ring_all_gather(chunk, axis, n, permute=permute)


def rhd_rsa(x: torch.Tensor, axis, permute=ppermute) -> torch.Tensor:
    """Recursive vector halving & doubling reduce-scatter/allgather: the
    paper's MVAPICH2-GDR allreduce.  Non-power-of-two p folds the excess
    ranks into the core first and broadcasts the result back after
    (+2 steps, +2N bytes), exactly as the reference does.

    The allgather and post-broadcast hops keep the value they sent (see
    ``core/codec.py``): each block's holders re-encode identical copies
    at every hop, so on a coded wire every rank ends with the same bits
    (the reference leaves each chunk's owner with its unquantized sum).
    Those hops send ``mask`` (then ``core``) chunks that were each
    decoded at their own scale, and ship each at that scale, so only the
    first encode of a chunk rounds it."""
    p = axis_size(axis)
    if p == 1:
        return x
    core = _pow2_core(p)
    r = p - core
    x, n = _pad_leading(x, core)
    idx = axis_index(axis)
    hop = _as_hop(permute)

    if r:
        # Pre-fold: excess rank core+j ships its buffer to core rank j;
        # non-targets receive zeros, so one add applies it where it lands.
        pre = [(core + j, j) for j in range(r)]
        x = hop(x, axis, pre, add=x)

    buf = x
    mask = core // 2
    while mask >= 1:
        perm = [(i, i ^ mask) for i in range(core)]
        half = buf.shape[0] // 2
        lower, upper = buf[:half], buf[half:]
        send, keep = (lower, upper) if idx & mask else (upper, lower)
        buf = hop(send, axis, perm, add=keep)
        mask //= 2

    mask = 1
    while mask < core:
        perm = [(i, i ^ mask) for i in range(core)]
        recv, buf = hop(buf, axis, perm, keep_sent=True, blocks=mask)
        buf = torch.cat([recv, buf] if idx & mask else [buf, recv], dim=0)
        mask *= 2

    if r:
        post = [(j, core + j) for j in range(r)]
        recv, buf = hop(buf, axis, post, keep_sent=True, blocks=core)
        if idx >= core:
            buf = recv
    return buf[:n]


def ps_gather(x: torch.Tensor, axis, *, fused: bool = False) -> torch.Tensor:
    """Every rank ships its full gradient (p·N ingress bytes) and reduces
    locally — the parameter-server pattern.  ``fused=True`` routes the
    terminal reduction through kernel K4 (``kernels/fused_reduce.py``, one
    f32 pass — the paper's C2 reduction kernel) instead of ``torch.sum``."""
    gathered = all_gather(x, axis)          # (p, ...)
    if fused:
        p = gathered.shape[0]
        out = fused_reduce(gathered.reshape(p, -1), out_dtype=x.dtype)
        return out.reshape(x.shape)
    return torch.sum(gathered, dim=0)


# ---------------------------------------------------------------------------
# stage executor
# ---------------------------------------------------------------------------

def _stage_permute(st):
    """The hop primitive for one stage (see the reference's
    ``_stage_permute``): plain ``ppermute``, a codec permuter, or the
    fused-kernel permuter."""
    from . import codec as codec_mod
    cname = getattr(st, "codec", "none") or "none"
    fused = bool(getattr(st, "fused_hop", False))
    if fused and st.algorithm not in FUSED_HOP_ALGORITHMS:
        raise ValueError(
            f"fused_hop on {st.op}@{st.axis} ({st.algorithm}): only "
            f"{FUSED_HOP_ALGORITHMS} expose a fusable accumulate")
    if cname == "none":
        if fused and st.algorithm in ("ring_rsa", "rhd_rsa"):
            return codec_mod.permuter("none", fused=True)
        return ppermute
    if st.algorithm not in codec_mod.CODED_ALGORITHMS:
        raise ValueError(
            f"codec {cname!r} on {st.op}@{st.axis} ({st.algorithm}): only "
            f"{codec_mod.CODED_ALGORITHMS} expose ppermute hop boundaries")
    return codec_mod.permuter(cname, fused=fused)


_FLAT_FNS = {"psum": psum, "ring_rsa": ring_rsa, "rhd_rsa": rhd_rsa,
             "ps_gather": ps_gather}


def _traced_permute(tracer, inner, st, stage_path):
    """Wrap a stage's hop primitive so every hop records a telemetry
    span (``<stage_path>.hop[k]``) with its payload bytes (the tensor
    handed to the hop, before any encode), its edges and its codec.  On
    a coded stage ``inner`` encodes, ships and decodes, so the span
    covers all three.  The wrapper keeps the hop protocol:
    ``add``, ``keep_sent`` and ``blocks`` (each joined chunk at its own
    scale) reach ``inner`` unchanged."""
    cname = getattr(st, "codec", "none") or "none"
    counter = [0]
    inner_hop = _as_hop(inner)

    def permute(x, group, perm, add=None, keep_sent=False, blocks=1):
        k = counter[0]
        counter[0] += 1
        with tracer.span(f"hop[{k}]", cat="trace",
                         ir_path=f"{stage_path}.hop[{k}]",
                         payload_bytes=x.numel() * x.element_size(),
                         n_edges=len(perm), codec=cname):
            return inner_hop(x, group, perm, add=add, keep_sent=keep_sent,
                             blocks=blocks)

    permute.supports_add = True
    return permute


def execute_stages(x: torch.Tensor, stages, groups) -> torch.Tensor:
    """Run a bucket's decomposition tree.  ``groups`` maps each stage's
    axis name to its :class:`~repro_torch.core.dist.Group`.

    ``reduce_scatter``/``all_gather`` pairs nest like parentheses; the
    ``shard`` opener keeps this rank's chunk in the ring ownership
    convention.  A coded stage list runs in float32 and casts back to the
    buffer's dtype at the end."""
    coded = any((getattr(st, "codec", "none") or "none") != "none"
                for st in stages)
    orig_dtype = x.dtype
    if coded and x.dtype != torch.float32:
        x = x.to(torch.float32)
    tracer = telemetry_trace.get_tracer()
    pending: list = []
    for j, st in enumerate(stages):
        group = groups[st.axis]
        permute = _stage_permute(st)
        if tracer.enabled:
            # The enclosing bucket span (opened by the executor) gives
            # the path's base; a bare stage list gets "stage[j]" alone.
            base = tracer.current_path()
            path = f"{base}.stage[{j}]" if base else f"stage[{j}]"
            ctx = tracer.span(
                f"stage[{j}]", cat="trace", ir_path=path, op=st.op,
                algorithm=st.algorithm, axis=st.axis,
                axis_size=int(st.axis_size), n_bytes=int(st.n_bytes),
                wire_bytes=int(st.wire_bytes),
                codec=getattr(st, "codec", "none") or "none")
            # Only the ppermute-hop algorithms take a hop primitive.
            if st.op != "allreduce" or st.algorithm in ("ring_rsa",
                                                        "rhd_rsa"):
                permute = _traced_permute(tracer, permute, st, path)
        else:
            ctx = tracer.span("")           # the shared no-op
        with ctx:
            if st.op == "reduce_scatter":
                if st.algorithm != "ring_rsa":
                    raise ValueError(f"unknown reduce-scatter algorithm "
                                     f"{st.algorithm!r}")
                x, n = ring_reduce_scatter(x, group, permute=permute)
                pending.append((st.axis, n))
            elif st.op == "shard":
                p = axis_size(group)
                x, n = _pad_leading(x, p)
                cl = x.shape[0] // p
                start = ((axis_index(group) + 1) % p) * cl
                x = x[start:start + cl]
                pending.append((st.axis, n))
            elif st.op == "all_gather":
                if not pending or pending[-1][0] != st.axis:
                    raise ValueError(f"all_gather@{st.axis} without a "
                                     f"matching reduce_scatter (pending "
                                     f"{pending})")
                _, n = pending.pop()
                x = ring_all_gather(x, group, n, permute=permute)
            elif st.op == "allreduce":
                fn = _FLAT_FNS.get(st.algorithm)
                if fn is None:
                    raise ValueError(f"unknown allreduce algorithm "
                                     f"{st.algorithm!r}")
                if st.algorithm == "ps_gather":
                    x = fn(x, group,
                           fused=bool(getattr(st, "fused_hop", False)))
                elif st.algorithm == "psum":
                    x = fn(x, group)
                else:
                    x = fn(x, group, permute=permute)
            else:
                raise ValueError(f"unknown stage op {st.op!r}")
    if pending:
        raise ValueError(f"unterminated reduce_scatter stages: {pending}")
    if coded and x.dtype != orig_dtype:
        x = x.to(orig_dtype)
    return x


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, axes, strategy: str) -> torch.Tensor:
    """Sum-allreduce ``x`` over the groups ``axes`` (outermost first)
    with ``strategy``: the stages of its decomposition tree (a flat name
    folds a full allreduce per axis, innermost first; ``hierarchical``
    is ``ring_rsa×rhd_rsa`` on two axes and ``ring_rsa`` on one)."""
    from . import schedule
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    names = tuple(f"ax{i}" for i in range(len(tuple(axes))))
    groups = dict(zip(names, axes))
    stages = schedule.decompose(strategy, x.numel() * x.element_size(),
                                names, [axis_size(g) for g in groups.values()])
    return execute_stages(x, stages, groups)


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------

def hop_elements(algorithm: str, shape, p: int,
                 op: str = "allreduce") -> tuple[int, int]:
    """``(largest ppermute payload, all_gather row)`` in elements, for
    one stage ``op`` running ``algorithm`` on a buffer of ``shape`` over
    ``p`` ranks: what a transport's receive slots must hold.  Ring hops
    carry one chunk of the padded rows (a ``reduce_scatter``'s input is
    the whole buffer, an ``all_gather``'s the chunk itself); RHD's first
    halving hop half the rows, its pre- and post-fold (non-power-of-two
    p) all of them; ``ps_gather`` gathers the whole buffer; ``psum`` and
    the local ``shard`` have no hop."""
    p = int(p)
    rows = int(shape[0]) if len(shape) else 1
    inner = 1
    for d in tuple(shape)[1:]:
        inner *= int(d)
    if op == "all_gather":
        if algorithm != "ring_rsa":
            raise ValueError(f"unknown all-gather algorithm {algorithm!r}")
        return (rows * inner if p > 1 else 0), 0
    if op == "reduce_scatter" and algorithm != "ring_rsa":
        raise ValueError(f"unknown reduce-scatter algorithm {algorithm!r}")
    if op == "shard" or p == 1 or algorithm == "psum":
        return 0, 0
    if op not in ("allreduce", "reduce_scatter"):
        raise ValueError(f"unknown stage op {op!r}")
    if algorithm == "ring_rsa":
        return -(-rows // p) * inner, 0
    if algorithm == "rhd_rsa":
        core = _pow2_core(p)
        padded = -(-rows // core) * core
        return (padded if core != p else padded // 2) * inner, 0
    if algorithm == "ps_gather":
        return 0, rows * inner
    raise ValueError(f"unknown allreduce algorithm {algorithm!r}")


def hop_scales(algorithm: str, p: int) -> int:
    """The most scale scalars one hop of ``algorithm`` over ``p`` ranks
    carries on a scaled codec: RHD's doubling hops ship one per chunk
    they join (``core / 2`` on the last), its post-fold ``core``; every
    other hop one."""
    if algorithm != "rhd_rsa" or p < 2:
        return 1
    core = _pow2_core(int(p))
    return core if core != p else max(core // 2, 1)


def hierarchical_wire_bytes(n_bytes: int, d: int, pods: int) -> dict:
    """Per-level wire bytes of the two-level schedule on the busiest
    rank: ``intra`` (ring reduce-scatter + all-gather over d) and
    ``inter`` (RHD of the 1/d chunk over the pods), kept apart because
    the two levels ride different links."""
    if d == 1:
        return {"intra": 0, "inter": wire_bytes("rhd_rsa", n_bytes, pods)}
    intra = 2 * int(n_bytes * (d - 1) / d)
    inter = wire_bytes("rhd_rsa", n_bytes // d, pods)
    return {"intra": intra, "inter": inter}


def _axis_sizes(p) -> tuple[int, ...]:
    """A rank count (int) or per-axis sizes (outermost first) as a
    tuple."""
    if isinstance(p, int):
        return (p,)
    sizes = tuple(int(s) for s in p)
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"axis sizes must be positive ints, got {p!r}")
    return sizes


def wire_bytes(strategy: str, n_bytes: int, p) -> int:
    """Algorithmic wire bytes per device (critical path) of one
    allreduce over ``p`` ranks, or over per-axis sizes ``(pods, d)``
    (outermost first): a flat strategy folds a full allreduce per axis
    and sums them, ``hierarchical`` charges its two levels (ring on a
    single axis).  Non-pow2 ``rhd_rsa`` adds the 2N pre/post fold on the
    busiest core rank."""
    sizes = _axis_sizes(p)
    if strategy == "hierarchical":
        if len(sizes) == 1:
            return wire_bytes("ring_rsa", n_bytes, sizes[0])
        if len(sizes) != 2:
            raise ValueError("hierarchical expects (pods, d) axis sizes")
        pods, d = sizes
        levels = hierarchical_wire_bytes(n_bytes, d=d, pods=pods)
        return levels["intra"] + levels["inter"]
    if len(sizes) > 1:
        return sum(wire_bytes(strategy, n_bytes, s) for s in sizes)
    (p,) = sizes
    if p == 1:
        return 0
    if strategy == "rhd_rsa":
        core = _pow2_core(p)
        extra = 0 if core == p else 2 * n_bytes
        return int(2 * n_bytes * (core - 1) / core) + extra
    if strategy in ("ring_rsa", "psum"):
        return int(2 * n_bytes * (p - 1) / p)
    if strategy == "ps_gather":
        return int(n_bytes * (p - 1))
    raise ValueError(strategy)


def allreduce_steps(strategy: str, p) -> int:
    """Sequential communication steps on the critical path, over ``p``
    ranks or per-axis sizes (flat strategies sum their per-axis
    allreduces; ``hierarchical`` charges ring RS + RHD + ring AG)."""
    sizes = _axis_sizes(p)
    if strategy == "hierarchical":
        if len(sizes) == 1:
            return allreduce_steps("ring_rsa", sizes[0])
        if len(sizes) != 2:
            raise ValueError("hierarchical expects (pods, d) axis sizes")
        pods, d = sizes
        return 2 * (d - 1) + allreduce_steps("rhd_rsa", pods)
    if len(sizes) > 1:
        return sum(allreduce_steps(strategy, s) for s in sizes)
    (p,) = sizes
    if p == 1:
        return 0
    if strategy == "rhd_rsa":
        core = _pow2_core(p)
        pre_post = 0 if core == p else 2
        return 2 * core.bit_length() - 2 + pre_post
    if strategy == "ring_rsa":
        return 2 * (p - 1)
    if strategy == "ps_gather":
        return 2
    if strategy == "psum":
        raise ValueError("psum steps are vendor-chosen; use cost_model")
    raise ValueError(strategy)
