"""Architecture registry: ``--arch <id>`` resolution.

The dense family is ported whole: smollm-360m, granite-3-2b,
deepseek-7b and gemma-7b (head_dim 256, GeGLU, scaled tied embeddings).
The other families' specs join with their families (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import importlib

from ..models.common import ModelSpec

ARCHS = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_spec(name: str) -> ModelSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {list_archs()}")
    return importlib.import_module(ARCHS[name]).SPEC
