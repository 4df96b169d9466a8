"""Hand-written Hopper kernels and their plain torch versions.

K1–K3 (``fused_hop``): the paper's fused reduction hop.  K4
(``fused_reduce``): the parameter-server pattern's terminal sum.  K5
(``fused_adamw``): the optimizer's one-pass update.  K6
(``fused_rmsnorm``): every norm of the transformer.  K7/K8
(``flash_attention``): attention above ``attn_full_seq_max``, forward
and FlashAttention-2 backward.  Each wrapper runs its kernel on CUDA
tensors and its plain version on CPU tensors.
"""
from .backend import resolve_device
from .flash_attention import (FlashAttnFn, flash_attention_bwd,
                              flash_attention_fwd)
from .fused_adamw import adamw_update
from .fused_hop import HOP_CODECS, hop_absmax, hop_decode_add, hop_encode
from .fused_reduce import fused_reduce
from .fused_rmsnorm import RMSNormFn

__all__ = ["FlashAttnFn", "HOP_CODECS", "RMSNormFn", "adamw_update",
           "flash_attention_bwd", "flash_attention_fwd", "fused_reduce",
           "hop_absmax", "hop_decode_add", "hop_encode", "resolve_device"]
