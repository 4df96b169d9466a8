"""Characterization: the paper's experiment matrix as data.

Counterpart of ``repro/experiments``.  ``matrix`` is the declarative
grid (design × model × p × per-device batch) on the analytic backend,
and the schedule cells that ``python -m repro_torch.analysis
--schedules`` verifies.  The measured backend, the claims registry and
the regenerator are not ported yet (ROADMAP, Queue 1).
"""
from .matrix import (BATCHES, DESIGN_STRATEGY, DESIGNS, PROFILES, WORKERS,
                     ExperimentPoint, HwProfile, compute_seconds,
                     design_latency_fn, grid, run_matrix, run_point,
                     step_time, step_timeline, throughput)

__all__ = [
    "BATCHES", "DESIGN_STRATEGY", "DESIGNS", "PROFILES", "WORKERS",
    "ExperimentPoint", "HwProfile", "compute_seconds", "design_latency_fn",
    "grid", "run_matrix", "run_point", "step_time", "step_timeline",
    "throughput",
]
