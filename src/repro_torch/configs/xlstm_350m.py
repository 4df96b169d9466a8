"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1] ratio).
[arXiv:2405.04517]

Assigned: 24L d_model=1024 4H (kv=4) d_ff=0 (no separate FFN; projections
live inside the blocks) vocab=50304. O(1) recurrent state -> long_500k
native.  ``mlstm_chunk`` stays 0 as published: the mLSTM runs its
sequential scan.
"""
from repro_torch.models.common import ModelSpec

SPEC = ModelSpec(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    slstm_every=8,             # every 8th block sLSTM => 21 mLSTM + 3 sLSTM
)
