"""Train, eval and serve step functions.

``train_step_fn`` is (state, batch) -> (state, metrics), the reference's
pure step on trees of tensors: autograd gives the gradients, and
``optim.adamw.update`` applies them (with ``masks`` it keeps a pruning
mask invariant, for sparse finetuning). The reference jits its steps;
PyTorch runs them eagerly, so ``make_train_step`` and
``make_serve_steps`` only bind their arguments.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import ckpt
from repro_torch.models import ModelApi, transformer
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    """Checkpoints under the reference's leaf paths: ``.params/...``,
    ``.opt/.m/...``, ``.opt/.v/...``, ``.opt/.step``."""
    params: Any
    opt: adamw.AdamWState


def init_state(api: ModelApi, *, seed: int = 0, device="cuda") -> TrainState:
    params = api.init(seed=seed, device=device)
    return TrainState(params=params, opt=adamw.init(params))


def restore_params(api: ModelApi, ckpt_dir, *, device) -> dict:
    """The params of the newest TrainState checkpoint under ``ckpt_dir``
    whose params read back and pass their hash checks (written by either
    package), on ``device``; the optimizer state is not read."""
    like = TrainState(params=api.init(device="meta"), opt=None)
    found = ckpt.restore_latest_like(ckpt_dir, like, device=device)
    if found is None:
        raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    return found[1].params


def value_and_grad(loss_fn, tree):
    """(loss_fn(tree) -> (loss, aux), grads shaped like ``tree``)."""
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        loss, aux = loss_fn(adamw.tree_map(track, tree))
        grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), aux), adamw.tree_map(lambda _: next(grads), tree)


def _detached(aux: dict) -> dict:
    return {k: v.detach() for k, v in aux.items() if k != "taps"}


def train_step_fn(api: ModelApi, opt_cfg: adamw.AdamWConfig, *, masks=None):
    """The train step (state, batch) -> (state, metrics).

    ``cfg.grad_accum`` > 1 splits the batch into that many microbatches,
    runs them in order and sums their gradients in fp32, then divides by
    the count; loss and aux are the microbatches' means, so the metric
    keys are those of ``grad_accum == 1``.
    """
    accum = max(api.cfg.grad_accum, 1)

    def grad_fn(params, batch):
        return value_and_grad(lambda p: api.loss(p, batch, masks=masks),
                              params)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if accum == 1:
            (loss, aux), grads = grad_fn(state.params, batch)
            aux = _detached(aux)
        else:
            grads, losses, auxes = None, [], []
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, a), g = grad_fn(state.params, mb)
                g = adamw.tree_map(lambda x: x.to(torch.float32), g)
                grads = g if grads is None else adamw.tree_map(
                    torch.add, grads, g)
                losses.append(l)
                auxes.append(_detached(a))
            grads = adamw.tree_map(lambda g: g / accum, grads)
            loss = torch.mean(torch.stack(losses))
            aux = {k: torch.mean(torch.stack([a[k] for a in auxes]), dim=0)
                   for k in auxes[0]}
        new_params, new_opt, om = adamw.update(
            opt_cfg, grads, state.opt, state.params, masks=masks)
        return TrainState(new_params, new_opt), {"loss": loss, **aux, **om}

    return step


def make_train_step(api: ModelApi, opt_cfg: adamw.AdamWConfig, *,
                    masks=None):
    """The train step with ``masks`` bound: masks are static artifacts of
    a sparse-finetune job, not per-step inputs."""
    return train_step_fn(api, opt_cfg, masks=masks)


def make_eval_step(api: ModelApi, *, masks=None):
    """(params, batch) -> (mean CE, valid-token count), without autograd."""
    @torch.no_grad()
    def step(params, batch):
        _, aux = api.loss(params, batch, masks=masks)
        return aux["ce"], (batch["labels"] >= 0).to(torch.float32).sum()

    return step


@torch.no_grad()
def eval_metrics(api: ModelApi, params, batches, *, masks=None) -> dict:
    """{"perplexity", "accuracy"} over an iterable of batches, both from
    one forward a batch. Perplexity: each batch's mean CE weighs by its
    valid-token count, so a ragged last batch or padded prompts do not
    bias it; exp in fp32, as the reference takes it. Accuracy: next-token
    top-1 hits over the valid tokens."""
    tot, n, hits = 0.0, 0.0, 0.0
    for b in batches:
        hidden, _, _ = api.forward(params, b, masks=masks)
        logits = api.module.lm_head(params, hidden, api.cfg)
        valid = b["labels"] >= 0
        cnt = float(valid.to(torch.float32).sum())
        tot += float(transformer.ce_of_logits(logits, b["labels"])) * cnt
        n += cnt
        hits += float(((torch.argmax(logits, dim=-1) == b["labels"])
                       & valid).sum())
    return {"perplexity": float(torch.exp(torch.tensor(
                tot / max(n, 1.0), dtype=torch.float32))),
            "accuracy": hits / max(n, 1.0)}


def perplexity(api: ModelApi, params, batches, *, masks=None) -> float:
    """Token-weighted mean-CE perplexity (``eval_metrics``)."""
    return eval_metrics(api, params, batches, masks=masks)["perplexity"]


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
