"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Assigned: 24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    num_experts=32,
    top_k=8,
    moe_d_ff=512,
)
