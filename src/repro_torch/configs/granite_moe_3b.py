"""granite-moe-3b-a800m [moe] — 40 fine-grained experts, top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-*-base; hf]

Tokens are dispatched in groups of 256 consecutive positions
(``moe_group_size``) where that divides the sequence, else over the
whole sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                 # per-expert hidden: fine-grained experts
    vocab_size=49155,
    mlp="gated",
    act="silu",
    n_experts=40,
    top_k=8,
    moe_group_size=256,
    grad_accum=2,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, n_experts=8, top_k=2, dtype="float32",
)
