"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81L d_model=3584 32H (kv=32, MHA) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242]

One shared attn+MLP block (input concat([hidden, embedding]), 2*d wide)
invoked every 6 backbone layers; its weights are pruned ONCE with the
Gram summed over all invocation sites. SSM state is O(1) a sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=224,                # shared attn runs at concat width 2*d: 32*224=7168
    d_ff=14336,
    vocab_size=32000,
    grad_accum=2,
    mlp="gated",
    act="gelu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=64,
    shared_attn_every=6,
)

TINY = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=32, d_ff=96,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    shared_attn_every=2, dtype="float32",
)
