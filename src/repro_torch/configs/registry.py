"""Architecture registry: ``--arch <id>`` resolution.

Only the specs whose family is ported are listed; the others join with
their families (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import importlib

from ..models.common import ModelSpec

ARCHS = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_spec(name: str) -> ModelSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {list_archs()}")
    return importlib.import_module(ARCHS[name]).SPEC
