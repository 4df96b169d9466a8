"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]

Assigned: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
