"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
[arXiv:2404.05892]

O(1) serving state per layer: the (H, dh, dh) WKV matrix and the two
token-shift vectors.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    norm="layernorm",
    rwkv_head_dim=64,
    rwkv_chunk=16,
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    rwkv_head_dim=16, rwkv_chunk=8, rwkv_lora_decay=8, rwkv_lora_mix=4,
    dtype="float32",
)
