"""phi-3-vision-4.2b [vlm] — phi3-mini decoder backbone consuming CLIP
patch embeddings. Vision encoder is a STUB per the mandated carve-out:
input_specs provides (batch, 576, d_model) patch embeddings.
[hf:microsoft/Phi-3-vision-128k-instruct]

Assigned: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
Its head_dim is 3072 / 32 = 96; 576 patches and a text prompt pass
``attn_full_seq_max``, so its attention runs K7/K8 at head_dim 96.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    rope_theta=10000.0,
    num_image_tokens=576,      # 24x24 CLIP patch grid
)
