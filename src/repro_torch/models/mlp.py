"""Feed-forward blocks: gated (SwiGLU-family) and plain two-matrix MLPs."""
from __future__ import annotations

import torch

from . import common
from .common import dense

PRUNABLE_MLP = ("w_gate", "w_up", "w_down")


def init_mlp_params(gen, cfg, *, device, d_in: int | None = None) -> dict:
    """``d_in`` overrides the input width (zamba's shared block: 2·d)."""
    d = d_in or cfg.d_model
    dt = getattr(torch, cfg.dtype)
    if cfg.mlp == "gated":
        return {
            "w_gate": common.linear_init(gen, cfg.d_ff, d, dt, device),
            "w_up": common.linear_init(gen, cfg.d_ff, d, dt, device),
            "w_down": common.linear_init(gen, cfg.d_model, cfg.d_ff, dt, device),
        }
    return {
        "w_up": common.linear_init(gen, cfg.d_ff, d, dt, device),
        "w_down": common.linear_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def mlp_block(p, x, cfg, *, masks=None, taps=None) -> torch.Tensor:
    """Gated/plain MLP; taps are emitted in the reference's order."""
    m = (lambda n: None) if masks is None else masks.get
    if "w_gate" in p:
        up = dense(x, p["w_up"], mask=m("w_up"), tap="w_up", taps=taps)
        gate = dense(x, p["w_gate"], mask=m("w_gate"), tap="w_gate",
                     taps=taps, act=cfg.act)
        h = gate * up
    else:
        h = dense(x, p["w_up"], mask=m("w_up"), tap="w_up", taps=taps,
                  act=cfg.act)
    return dense(h, p["w_down"], mask=m("w_down"), tap="w_down", taps=taps)
