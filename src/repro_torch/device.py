"""Device choice and precision settings shared by the entry points.

Entry points run on "cuda" unless the caller asks for the CPU, and raise
when the card is missing: nothing probes for a GPU and quietly carries
on without one.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Full-fp32 matmuls and convolutions (TF32 keeps ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for "cuda" without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    return dev
