"""Characterization: the paper's experiment matrix as data.

Counterpart of ``repro/experiments``:

``matrix``  the declarative grid (design × model × p × per-device batch)
            on the analytic backend for any p, the measured backend on
            spawned ranks (the port's reducers, host or card), and the
            schedule cells that ``python -m repro_torch.analysis
            --schedules`` verifies;
``claims``  the paper's quantitative claims C1–C10, each a matrix query
            with a tolerance band;
``regen``   the CLI that regenerates and checks the port's committed
            ``artifacts_torch/EXPERIMENTS.md`` and ``experiments.json``.
"""
from .matrix import (BATCHES, DESIGN_STRATEGY, DESIGNS, PROFILES, WORKERS,
                     ExperimentPoint, HwProfile, bucket_sizes,
                     compute_seconds, design_latency_fn, grid,
                     measure_design_latencies, measure_points, run_matrix,
                     run_measured_point, run_point, step_time,
                     step_timeline, throughput)

__all__ = [
    "BATCHES", "DESIGN_STRATEGY", "DESIGNS", "PROFILES", "WORKERS",
    "ExperimentPoint", "HwProfile", "bucket_sizes", "compute_seconds",
    "design_latency_fn", "grid", "measure_design_latencies",
    "measure_points", "run_matrix", "run_measured_point", "run_point",
    "step_time", "step_timeline", "throughput",
]
