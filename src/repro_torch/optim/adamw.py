"""AdamW with warmup-cosine schedule, global-norm clipping, masked params.

The reference's optimizer (``repro.optim.adamw``) on trees of tensors:
nested dicts whose leaves are tensors, walked in sorted key order (the
order JAX flattens a dict in). State is a plain tree, so it checkpoints
like params. ``masks`` (the same substructure as the prunable params)
zero the gradient, the moments, the decay and the weight at pruned
entries: sparse finetuning keeps the mask invariant exactly.

The arithmetic is the reference's, in its order: every leaf computes in
fp32 and is cast to its param dtype once, at the end. The schedule and
the step counter stay on the params' device (no host read per step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor          # () int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` share the
    structure of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> AdamWState:
    """Zero fp32 moments shaped like ``params``, step 0, on their device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           masks=None, *, gnorm=None) -> tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, metrics).

    ``gnorm``: the clip's global norm, when the caller took it over more
    than these leaves (a rank's shards of a train state on a mesh: the
    norm of the whole gradient tree, ``train.steps.sharded_update``);
    default: ``global_norm`` of the (masked) ``grads``.

    With ``masks`` the mask invariant holds through the whole update:
    gradients are masked before the norm and the clip (``grad_norm``
    measures only trainable coordinates, and ``m`` / ``v`` stay exactly
    zero at pruned ones), weight decay decays the masked weight, and the
    returned params are masked again, so pruned entries come out bitwise
    zero even when the caller's forward pass did not mask.
    """
    if masks is not None:
        grads = apply_masks(grads, masks)
        params = apply_masks(params, masks)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    new_params = pick(0)
    if masks is not None:
        new_params = apply_masks(new_params, masks)
    return new_params, AdamWState(pick(1), pick(2), step), {
        "grad_norm": gnorm, "lr": lr}


def apply_masks(params, masks):
    """Zero pruned weights: ``masks`` is a sub-tree of ``params`` (the
    prunable leaves); leaves without a mask pass through."""
    def merge(p_sub, m_sub):
        if m_sub is None:
            return p_sub
        if isinstance(m_sub, dict):
            return {k: merge(p_sub[k], m_sub.get(k)) for k in p_sub}
        return p_sub * m_sub.to(p_sub.dtype)

    return merge(params, masks)
