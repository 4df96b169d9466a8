"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512, decoupled RoPE 64) +
64 routed experts top-6 + 2 shared experts, first layer dense.
[arXiv:2405.04434]

Assigned: 27L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=102400.
MLA latent decode cache -> runs long_500k natively (DESIGN.md §3.4).
MLA and the experts run outside any kernel (plain torch), as in the
reference; K6 takes every norm.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # routed-expert FF width
    vocab_size=102400,
    mlp_type="swiglu",
    rope_theta=10000.0,
    attention_type="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
)
