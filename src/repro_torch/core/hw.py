"""Hardware constants.

``V5E`` (with ``GRPC_ALPHA_S`` / ``GRPC_BANDWIDTH``) is the reference's
TPU v5e model (``repro/core/hw.py``), kept verbatim because the cost
model prices schedules with it, the experiment matrix's ``v5e`` profile
reads it, and the port's plans and characterization must be
byte-identical to the reference's.  It describes no hardware the port
runs on.

``H100_SXM`` is the published data sheet of the card the port targets
(NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates, 700 W):
the roofline bounds that ``chip_smoke.py`` reports, and
``launch/roofline.py``'s terms, are computed from it.  Its NVLink rate
is NVLink 4's 900 GB/s per GPU, 450 GB/s each direction: the link a
collective between cards crosses.  Ranks that share one card (the
``cuda_ipc`` hops of a one-card run) copy within its memory and never
cross NVLink, so a roofline priced on ``nvlink_bandwidth`` is the
multi-card step's, not such a run's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """The reference's TPU v5e constants that the cost model and the
    experiment matrix's ``v5e`` profile read."""
    peak_bf16_flops: float = 197e12      # FLOP/s per chip (MXU, bf16)
    hbm_bandwidth: float = 819e9         # bytes/s
    ici_link_bandwidth: float = 50e9     # bytes/s per ICI link
    ici_alpha_s: float = 1e-6
    dcn_bandwidth: float = 25e9          # bytes/s per chip, cross-pod
    dcn_alpha_s: float = 10e-6


V5E = Chip()

# The reference's gRPC/TCP transport, a cost-model entry only (high
# alpha, modest beta): the parameter server's link in the ``v5e``
# profile.  Like ``V5E``, a model of the reference's target, not of any
# link the port runs on.
GRPC_ALPHA_S = 100e-6
GRPC_BANDWIDTH = 10e9  # bytes/s


@dataclasses.dataclass(frozen=True)
class Gpu:
    name: str
    hbm_bandwidth: float        # bytes/s
    peak_f32_flops: float       # outside the tensor cores
    peak_bf16_flops: float      # tensor cores, dense
    hbm_bytes: float = 0.0      # device memory capacity
    nvlink_bandwidth: float = 0.0   # bytes/s per GPU, each direction


# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: 3.35 TB/s HBM3,
# 67 TFLOP/s FP32, 989 TFLOP/s dense BF16, 80 GB, NVLink 900 GB/s.
H100_SXM = Gpu("h100-sxm", hbm_bandwidth=3.35e12, peak_f32_flops=67e12,
               peak_bf16_flops=989e12, hbm_bytes=80e9,
               nvlink_bandwidth=450e9)
