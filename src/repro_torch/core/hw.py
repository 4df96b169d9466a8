"""Hardware constants.

``V5E`` is the reference's TPU v5e model (``repro/core/hw.py``), kept
verbatim because the cost model prices schedules with it and the port's
plans must be byte-identical to the reference's.  It describes no
hardware the port runs on.

``H100_SXM`` is the published data sheet of the card the port targets
(NVIDIA, SXM part, dense rates, 700 W): the roofline bounds that
``chip_smoke.py`` reports are computed from it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """The reference's TPU v5e constants that the cost model reads."""
    hbm_bandwidth: float = 819e9         # bytes/s
    ici_link_bandwidth: float = 50e9     # bytes/s per ICI link
    ici_alpha_s: float = 1e-6
    dcn_bandwidth: float = 25e9          # bytes/s per chip, cross-pod
    dcn_alpha_s: float = 10e-6


V5E = Chip()


@dataclasses.dataclass(frozen=True)
class Gpu:
    name: str
    hbm_bandwidth: float        # bytes/s
    peak_f32_flops: float       # outside the tensor cores
    peak_bf16_flops: float      # tensor cores, dense


H100_SXM = Gpu("h100-sxm", hbm_bandwidth=3.35e12, peak_f32_flops=67e12,
               peak_bf16_flops=989e12)
