"""zamba2-1.2b [hybrid] — Mamba2 backbone + one weight-shared attention
block applied periodically. [arXiv:2411.15242]

Assigned: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Mamba2 layers of d_inner 4096 (64 SSM heads of 64, conv
over 4224 channels); the shared block's RMSNorm runs over
concat(hidden, embedding), 4096 values a row (K6).
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    attn_every=6,            # 6 shared-attention applications over 38 layers
)
