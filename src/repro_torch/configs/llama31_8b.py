"""llama-3.1-8b — the paper's primary experimental architecture.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[arXiv:2407.21783]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama31-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp="gated",
    act="silu",
    rope_theta=500000.0,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, dtype="float32",
)
