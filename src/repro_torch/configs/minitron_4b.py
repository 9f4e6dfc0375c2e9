"""minitron-4b [dense] — pruned nemotron: squared-ReLU MLP, huge vocab.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    mlp="plain",
    act="relu2",           # nemotron squared relu
    rope_pct=0.5,          # nemotron partial rotary
)

TINY = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=128,
    vocab_size=512, dtype="float32",
)
