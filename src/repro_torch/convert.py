"""Carry parameter trees between the reference package and the port.

The reference's params, taken to numpy (``jax.tree.map(np.asarray,
params)``), are nested dicts of arrays; ``from_numpy`` turns them into the
port's nested dicts of tensors with the same keys and layouts: linear
weights stay (d_out, d_in) and per-layer leaves stay stacked on a leading
L axis (an MoE model's expert stacks keep their (L, E, d_out, d_in) and
its router its fp32; a VLM's self layers their (G, NS, ...) and its cross
layers' fp32 scalar gates their (G,)). ``to_numpy`` is the inverse. bfloat16 arrays
(ml_dtypes, as JAX exports them) travel through their 16-bit pattern;
``to_numpy`` returns bf16 tensors as float32, which holds every bf16
value exactly.

A reference ``PackedWeight`` leaf (after ``jax.tree.map(np.asarray, ...)``
its ``values``/``idx`` are numpy arrays) becomes the port's
``PackedWeight`` with the same arrays and format fields, and a reference
``TrainState`` (``params``, ``opt`` = ``AdamWState(m, v, step)``) the
port's ``TrainState``; ``to_numpy`` of a port ``TrainState`` gives
``{"params", "opt": {"m", "v", "step"}}``. Both are read by their
attributes, so nothing of the reference is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedWeight

_PACKED_FIELDS = ("values", "idx", "fmt", "d_in", "n", "m")


def _leaf_from_numpy(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_numpy(tree, *, device="cpu"):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device=device) for k, v in tree.items()}
    if hasattr(tree, "params") and hasattr(tree, "opt"):
        from repro_torch.optim.adamw import AdamWState
        from repro_torch.train.steps import TrainState

        o = tree.opt
        return TrainState(
            params=from_numpy(tree.params, device=device),
            opt=AdamWState(m=from_numpy(o.m, device=device),
                           v=from_numpy(o.v, device=device),
                           step=_leaf_from_numpy(o.step, device)))
    if all(hasattr(tree, f) for f in _PACKED_FIELDS):
        return PackedWeight(values=_leaf_from_numpy(tree.values, device),
                            idx=_leaf_from_numpy(tree.idx, device),
                            fmt=str(tree.fmt), d_in=int(tree.d_in),
                            n=int(tree.n), m=int(tree.m))
    return _leaf_from_numpy(tree, device)


def to_numpy(tree):
    """Nested dicts of tensors -> nested dicts of numpy arrays; a
    ``TrainState`` -> ``{"params", "opt": {"m", "v", "step"}}``."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "params") and hasattr(tree, "opt"):
        return {"params": to_numpy(tree.params),
                "opt": {"m": to_numpy(tree.opt.m), "v": to_numpy(tree.opt.v),
                        "step": to_numpy(tree.opt.step)}}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
