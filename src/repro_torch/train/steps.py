"""Serving steps: prefill and decode bound to a model, and greedy decode.

The reference jits these (``jax.jit``); PyTorch runs them eagerly, so
``make_serve_steps`` only binds the masks. The training and evaluation
steps of the reference's module join this file in the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelApi


def make_serve_steps(api: ModelApi, *, masks=None):
    """(prefill(params, batch, cache), decode(params, token, cache))."""
    def prefill(p, b, c):
        return api.prefill(p, b, c, masks=masks)

    def decode(p, t, c):
        return api.decode_step(p, t, c, masks=masks)

    return prefill, decode


@torch.no_grad()
def greedy_decode(api: ModelApi, params, prompt, n_new: int, *, masks=None):
    """Serve a batch of prompts: prefill + n_new greedy decode steps.
    Returns (B, n_new) int64 tokens."""
    B, S = prompt["tokens"].shape
    cache = api.init_cache(params, B, S + n_new)
    prefill, decode = make_serve_steps(api, masks=masks)
    logits, cache = prefill(params, prompt, cache)
    toks = [torch.argmax(logits[:, -1], dim=-1)]
    for _ in range(n_new - 1):
        logits, cache = decode(params, toks[-1][:, None], cache)
        toks.append(torch.argmax(logits[:, -1], dim=-1))
    return torch.stack(toks, dim=1)
