"""Architecture registry: ``--arch <id>`` resolution.

The transformer families are ported whole: dense (smollm-360m,
granite-3-2b, deepseek-7b, gemma-7b with head_dim 256, GeGLU and scaled
tied embeddings), MoE (granite-moe-1b-a400m; deepseek-v2-lite-16b with
MLA and a dense prefix layer) and the VLM backbone (phi-3-vision-4.2b,
head_dim 96); the Mamba2 hybrid (zamba2-1.2b), the xLSTM
(xlstm-350m) and the encoder-decoder (whisper-tiny): every arch of the
reference.
"""
from __future__ import annotations

import importlib

from ..models.common import ModelSpec

ARCHS = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_spec(name: str) -> ModelSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; "
                       f"available: {list_archs()}")
    return importlib.import_module(ARCHS[name]).SPEC
