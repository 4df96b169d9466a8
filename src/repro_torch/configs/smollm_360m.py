"""smollm-360m [dense] — llama-arch small model; the smallest
compute-per-gradient-byte arch in the pool (the paper's "MobileNet").
[hf:HuggingFaceTB/SmolLM-135M]

Assigned: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
