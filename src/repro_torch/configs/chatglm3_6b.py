"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2, qkv bias.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    mlp="gated",
    act="silu",
    qkv_bias=True,
    rope_pct=0.5,          # chatglm 2d rope: rotate half the head dim
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, dtype="float32",
)
