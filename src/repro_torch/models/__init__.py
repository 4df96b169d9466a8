"""Models: the transformer LM (dense, MoE and VLM families), the Mamba2
hybrid, the xLSTM LM, the encoder-decoder and the paper's CNNs."""
from .cnn import CnnSpec
from .common import ModelSpec
from .registry import (ModelApi, build_cnn, build_model, divisibility_check,
                       param_groups, param_pspecs)

__all__ = ["CnnSpec", "ModelApi", "ModelSpec", "build_cnn", "build_model",
           "divisibility_check", "param_groups", "param_pspecs"]
