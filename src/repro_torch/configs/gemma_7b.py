"""gemma-7b [dense] — GeGLU, head_dim=256, sqrt(d) embed scaling, tied
embeddings. [arXiv:2403.08295]

Assigned: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
Its head_dim (256) is not d_model / num_heads (192), so ``wq`` is
3072 x 4096 and ``wo`` 4096 x 3072; above ``attn_full_seq_max`` its
attention runs K7/K8 at head_dim 256.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,
)
