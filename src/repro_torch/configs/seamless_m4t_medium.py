"""seamless-m4t-medium [audio] — encoder-decoder, multimodal backbone.

12L d_model=1024 16H (kv=16, MHA) d_ff=4096 vocab=256206, enc-dec
[arXiv:2308.11596; hf]

The audio frontend is a stub: batch["src"] carries
precomputed frame embeddings (B, n_src_frames, d_model). 12 encoder +
12 decoder layers.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    mlp="plain",
    act="relu",
    n_src_frames=1024,
)

TINY = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, n_src_frames=16, dtype="float32",
)
