"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-*-Vision]

The vision frontend is a stub: batch["img"] carries precomputed patch
embeddings (B, n_img_tokens, d_model). The backbone is 80 self-attn
layers + 20 gated cross-attn layers (every 5th), all linears prunable
including cross q/k/v/o (the cross wk / wv Grams over image embeddings).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mlp="gated",
    act="silu",
    cross_attn_every=5,
    n_img_tokens=1600,
    grad_accum=4,              # the reference's train_4k microbatching
)

TINY = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, cross_attn_every=2, n_img_tokens=8, dtype="float32",
    grad_accum=1,                       # tiny batches aren't microbatched
)
