"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA
[arXiv:2401.04088; hf]

Dispatch groups span the whole sequence (``moe_group_size`` 0): each
expert's d_ff = 14336 is wide enough to feed the card at the capacity
buffers a whole sequence gives.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp="gated",
    act="silu",
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    grad_accum=2,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, n_experts=4, top_k=2, sliding_window=16,
    dtype="float32",
)
