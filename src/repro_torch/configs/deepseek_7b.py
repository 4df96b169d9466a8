"""deepseek-7b [dense] — llama-arch MHA. [arXiv:2401.02954]

Assigned: 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    mlp_type="swiglu",
    rope_theta=10000.0,
)
