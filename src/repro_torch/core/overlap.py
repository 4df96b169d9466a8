"""Bucket readiness (the part of ``repro/core/overlap.py`` the planner
needs).  In-backward overlap execution is not ported yet."""
from __future__ import annotations


def readiness_order(plan) -> tuple[int, ...]:
    """Bucket indices ordered earliest-ready first: descending minimum
    leaf index (backward produces high-index leaves' grads first)."""
    return tuple(sorted(range(len(plan.buckets)),
                        key=lambda i: -min(plan.buckets[i].leaf_indices)))
