"""granite-34b [dense] — MQA (kv=1), plain-GELU MLP, code model.

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    grad_accum=2,             # two microbatches per train step, as the
                              # reference's config sets it
    mlp="plain",
    act="gelu",
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, dtype="float32",
)
