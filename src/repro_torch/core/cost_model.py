"""Alpha-beta-gamma cost model (the part the planner and the selector
price with).

Counterpart of ``repro/core/cost_model.py``: the same formulas and the
same constants, so ``plan()``'s ``predicted_s`` (part of a schedule's
JSON) and every choice of ``strategy="auto"``'s analytic selector are
bit-identical to the reference's.  The constants model the reference's
TPU target (``hw.V5E``) and its link profiles; they are not H100
measurements, and no H100 link profile exists until the
micro-benchmark's measured table does.
"""
from __future__ import annotations

import dataclasses
import math

from . import hw
from .reducers import STRATEGIES, _pow2_core, allreduce_steps, wire_bytes


@dataclasses.dataclass(frozen=True)
class LinkParams:
    alpha_s: float
    bandwidth: float          # bytes/s

    @property
    def beta(self) -> float:  # s/byte
        return 1.0 / self.bandwidth


ICI = LinkParams(hw.V5E.ici_alpha_s, hw.V5E.ici_link_bandwidth)
DCN = LinkParams(hw.V5E.dcn_alpha_s, hw.V5E.dcn_bandwidth)
# The reference's gRPC/TCP transport (the ``v5e`` profile's PS link).
GRPC = LinkParams(hw.GRPC_ALPHA_S, hw.GRPC_BANDWIDTH)
PAPER_LINK = LinkParams(alpha_s=5e-6, bandwidth=8e9)
# The paper's P100 (fp32 peak): the experiment matrix's "paper" profile.
PAPER_P100_FLOPS = 10.6e12

LINK_PROFILES = {"ici": ICI, "dcn": DCN, "paper": PAPER_LINK}


def resolve_link(link) -> LinkParams:
    """A LinkParams, or a profile name from LINK_PROFILES."""
    if isinstance(link, LinkParams):
        return link
    try:
        return LINK_PROFILES[link]
    except KeyError:
        raise ValueError(
            f"unknown link profile {link!r}; one of {sorted(LINK_PROFILES)}")


GAMMA_S_PER_BYTE = 3.0 / hw.V5E.hbm_bandwidth
QUANT_GAMMA_S_PER_BYTE = 2.5 / hw.V5E.hbm_bandwidth
QUANT_GAMMA_FUSED_S_PER_BYTE = 1.0 / hw.V5E.hbm_bandwidth


def quant_gamma(fused: bool = False) -> float:
    """The codec compute toll per decoded wire byte."""
    return QUANT_GAMMA_FUSED_S_PER_BYTE if fused \
        else QUANT_GAMMA_S_PER_BYTE


# alpha = 0, beta = 0: splits a latency into its wire and reduce parts.
FREE_LINK = LinkParams(0.0, math.inf)


def allreduce_latency(strategy: str, n_bytes: float, p: int,
                      link: LinkParams = ICI,
                      gamma: float = GAMMA_S_PER_BYTE,
                      ps_shards: int = 1) -> float:
    """Predicted latency (s) of a sum-allreduce of ``n_bytes`` over
    ``p`` devices with ``strategy``."""
    if p == 1:
        return 0.0
    a, b = link.alpha_s, link.beta
    frac = (p - 1) / p
    if strategy == "ring_rsa":
        return 2 * (p - 1) * a + 2 * n_bytes * frac * b + n_bytes * frac * gamma
    if strategy == "rhd_rsa":
        core = _pow2_core(p)
        frac_core = (core - 1) / core
        extra_reduce = 0 if core == p else n_bytes
        return allreduce_steps("rhd_rsa", p) * a \
            + wire_bytes("rhd_rsa", int(n_bytes), p) * b \
            + (n_bytes * frac_core + extra_reduce) * gamma
    if strategy == "psum":
        vendor_alpha = 5 * a
        tree = 2 * math.ceil(math.log2(p)) * (vendor_alpha + n_bytes * b) \
            + n_bytes * gamma
        ring = 2 * (p - 1) * vendor_alpha + 2 * n_bytes * frac * b \
            + n_bytes * frac * gamma
        return min(tree, ring)
    if strategy == "ps_gather":
        s = max(1, ps_shards)
        ingress = p * n_bytes / s
        return 2 * a + 2 * ingress * b + p * n_bytes / s * gamma
    if strategy == "hierarchical":
        raise ValueError("use hierarchical_latency(n_bytes, d, pods)")
    raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")


# The paper's default MVAPICH2 (the reference's constants): the rate of
# staging between the card and the host, the host's reduction rate, and
# the driver's pointer query paid once a call.
STAGING_BANDWIDTH = 16e9
HOST_REDUCE_BANDWIDTH = 13e9
DRIVER_QUERY_S = 25e-6


def allreduce_latency_host_staged(strategy: str, n_bytes: float, p: int,
                                  link: LinkParams = ICI) -> float:
    """The paper's default MVAPICH2: reductions on the host (every call
    stages the payload down and up, and reduces at host-memory speed)
    and a driver pointer query per call — the two terms the paper's
    CUDA-kernel reduction and pointer cache remove."""
    base = allreduce_latency(strategy, n_bytes, p, link=link, gamma=0.0)
    frac = (p - 1) / p
    staged_bytes = 2 * n_bytes * frac
    reduce_bytes = 3 * n_bytes * frac
    return base + DRIVER_QUERY_S \
        + staged_bytes / STAGING_BANDWIDTH \
        + reduce_bytes / HOST_REDUCE_BANDWIDTH


def composed_latency(outer_alg: str, n_bytes: float, d: int, pods: int,
                     intra: LinkParams = ICI,
                     gamma: float = GAMMA_S_PER_BYTE) -> float:
    """Two-level composed schedule: ring reduce-scatter over d (intra)
    + ``outer_alg`` allreduce of N/d over pods (on :data:`DCN`, the
    reference's default cross-pod link) + ring allgather
    over d.  ``hierarchical`` is its ``outer_alg="rhd_rsa"`` point."""
    frac_d = (d - 1) / d
    rs = (d - 1) * intra.alpha_s + n_bytes * frac_d * intra.beta \
        + n_bytes * frac_d * gamma
    mid = allreduce_latency(outer_alg, n_bytes / d, pods, link=DCN,
                            gamma=gamma)
    ag = (d - 1) * intra.alpha_s + n_bytes * frac_d * intra.beta
    return rs + mid + ag


def hierarchical_latency(n_bytes: float, d: int, pods: int,
                         intra: LinkParams = ICI,
                         gamma: float = GAMMA_S_PER_BYTE) -> float:
    """The fixed-RHD point of :func:`composed_latency`."""
    return composed_latency("rhd_rsa", n_bytes, d, pods, intra=intra,
                            gamma=gamma)


def flat_multiaxis_latency(strategy: str, n_bytes: float, d: int, pods: int,
                           intra: LinkParams = ICI) -> float:
    """The flat fold over two axes: a full allreduce per axis."""
    return (allreduce_latency(strategy, n_bytes, d, link=intra)
            + allreduce_latency(strategy, n_bytes, pods, link=DCN))
