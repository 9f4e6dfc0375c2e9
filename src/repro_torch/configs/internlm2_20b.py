"""internlm2-20b [dense] — llama-style GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    grad_accum=2,             # two microbatches per train step, as the
                              # reference's config sets it
    mlp="gated",
    act="silu",
)

TINY = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, dtype="float32",
)
