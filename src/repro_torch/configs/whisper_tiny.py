"""whisper-tiny [audio] — encoder-decoder; mel+conv frontend is a STUB
per the mandated carve-out: input_specs provides (batch, 1500, 384) frame
embeddings. [arXiv:2212.04356]

Assigned: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  LayerNorm
(plain torch, not K6); the decoder's self-attention takes K7/K8 at
head_dim 64 above attn_full_seq_max, rope off.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    encoder_layers=4,
    encoder_seq=1500,          # 30s audio -> 1500 frames post conv-frontend
)
