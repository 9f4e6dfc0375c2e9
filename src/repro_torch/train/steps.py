"""Train, eval and serve step functions.

``train_step_fn`` is (state, batch) -> (state, metrics), the reference's
pure step on trees of tensors: autograd gives the gradients, and
``optim.adamw.update`` applies them (with ``masks`` it keeps a pruning
mask invariant, for sparse finetuning). The reference jits its steps;
PyTorch runs them eagerly, so ``make_train_step`` and
``make_serve_steps`` only bind their arguments.

On a mesh (``train_step_fn(mesh=)``) the TrainState lives sharded by
``dist.specs.state_pspecs`` (``state_layout``, ``dist.placement``), and
every rank passes the same global batch. A step gathers the params whole
(the whole model sits on each rank while it computes: gathering layer by
layer is ROADMAP A5's next memory item), runs forward and backward on the
rank's slice of each microbatch (``batch_pspecs``: over "pod" and
"data"), all-reduces the gradients over those axes, and updates only the
rank's shard (``sharded_update``). The loss is one device's: the CE
summed over the slice, over the all-reduced count of valid tokens; the
clip's norm is taken over the whole gradient tree, as one device takes
it. A mesh whose data axes do not split the batch (one rank, or "model"
only) computes the whole batch on every rank, as one device does, so its
step is bitwise one device's; a split reorders fp32 sums of partial
gradients. An MoE model's aux loss and capacity groups span the whole
batch, so a split raises for it (ROADMAP A5, item 1's remainder).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import ckpt
from repro_torch.dist import groups as groups_lib
from repro_torch.dist import placement
from repro_torch.dist import specs as specs_lib
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


def _microbatches(batch: dict, accum: int) -> list[dict]:
    if accum == 1:
        return [batch]
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def _accum_grads(grad_fn, tree, batch, accum: int):
    """(loss, aux, grads) of ``grad_fn(tree, microbatch)`` over ``accum``
    microbatches, their gradients summed in fp32 and divided by the count;
    loss and aux are the microbatches' means."""
    if accum == 1:
        (loss, aux), grads = grad_fn(tree, batch)
        return loss, _detached(aux), grads
    grads, losses, auxes = None, [], []
    for mb in _microbatches(batch, accum):
        (l, a), g = grad_fn(tree, mb)
        g = adamw.tree_map(lambda x: x.to(torch.float32), g)
        grads = g if grads is None else adamw.tree_map(torch.add, grads, g)
        losses.append(l)
        auxes.append(_detached(a))
    grads = adamw.tree_map(lambda g: g / accum, grads)
    loss = torch.mean(torch.stack(losses))
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes]), dim=0)
           for k in auxes[0]}
    return loss, aux, grads


def _data_group(api: ModelApi, batch: dict, mesh):
    """The data-parallel group when its axes split ``batch`` over more
    than one rank, else None (every rank computes the whole batch)."""
    sizes = groups_lib.axis_sizes(mesh)
    dp = specs_lib._dp_axes(sizes)
    if not dp or specs_lib._axes_size(sizes, dp) == 1:
        return None
    spec = specs_lib.batch_pspecs(api.cfg, batch, mesh)
    if any(sp[:1] in ((), (None,)) for sp in adamw.tree_leaves(spec)):
        return None
    return groups_lib.axis_group(mesh, dp)


def mesh_value_and_grad(api: ModelApi, params_of, tree, batch, mesh, *,
                        masks=None, accum: int = 1):
    """(loss, aux, grads) of ``api.loss(params_of(tree), ...)`` on the
    global ``batch`` with respect to ``tree`` (whole on every rank), over
    ``accum`` microbatches, each split over the mesh's data axes: every
    rank ends with the gradients of the whole batch. Without a split it
    is one device's computation."""
    def grad_fn(t, b):
        return value_and_grad(
            lambda x: api.loss(params_of(x), b, masks=masks), t)

    data = _data_group(api, _microbatches(batch, accum)[0], mesh)
    if data is None:
        return _accum_grads(grad_fn, tree, batch, accum)
    if api.cfg.is_moe:
        raise NotImplementedError(
            "an MoE step with the batch split over the data axes is not "
            "ported: its aux loss and capacity groups span the whole batch "
            "(ROADMAP A5, item 1's remainder); use a mesh whose data axes "
            "are 1")
    grads, losses = None, []
    for mb in _microbatches(batch, accum):
        local = placement.shard(
            mb, specs_lib.batch_pspecs(api.cfg, mb, mesh), mesh)
        n = data.all_reduce((local["labels"] >= 0).to(torch.float32).sum())

        def loss_fn(x):
            # the slice's CE sum over the global count of valid tokens
            p = params_of(x)
            hidden, _, _ = api.forward(p, local, masks=masks)
            tot, _ = transformer._ce_sums(
                api.module.lm_head(p, hidden, api.cfg), local["labels"])
            return tot / torch.clamp(n, min=1.0), {}

        (l, _), g = value_and_grad(loss_fn, tree)
        g = adamw.tree_map(lambda x: data.all_reduce(x.to(torch.float32)), g)
        grads = g if grads is None else adamw.tree_map(torch.add, grads, g)
        losses.append(data.all_reduce(l))
    if accum == 1:
        grads = adamw.tree_map(lambda g, t: g.to(t.dtype), grads, tree)
    else:
        grads = adamw.tree_map(lambda g: g / accum, grads)
    loss = losses[0] if accum == 1 else torch.mean(torch.stack(losses))
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads


def abstract_state(api: ModelApi) -> TrainState:
    """The model's TrainState on the meta device (shapes and dtypes)."""
    params = api.init(device="meta")
    return TrainState(params, adamw.init(params))


def state_layout(api: ModelApi, mesh, state=None) -> placement.Layout:
    """The ``state_pspecs`` of a TrainState (default: the model's, from
    its shapes on the meta device) on ``mesh``."""
    if state is None:
        state = abstract_state(api)
    return placement.Layout(specs_lib.state_pspecs(api.cfg, state, mesh),
                            mesh)


def shard_state(state: TrainState, layout: placement.Layout) -> TrainState:
    """This rank's shard of a whole TrainState."""
    return placement.shard(state, layout.specs, layout.mesh)


def _sub_specs(specs, masks):
    """The specs of a sub-tree (the masks of the prunable params)."""
    if isinstance(masks, dict):
        return {k: _sub_specs(specs[k], v) for k, v in masks.items()}
    return specs


def sharded_update(opt_cfg: adamw.AdamWConfig, grads, state: TrainState,
                   layout: placement.Layout, *, masks=None):
    """AdamW on this rank's shard of ``state`` from the whole ``grads``
    (every rank holds them): the clip's norm over the whole (masked)
    tree, as one device takes it, then each leaf's shard updated
    elementwise. Returns (state, optimizer metrics)."""
    mesh, pspecs = layout.mesh, layout.specs.params
    if masks is not None:
        grads = adamw.apply_masks(grads, masks)
        masks = placement.shard(masks, _sub_specs(pspecs, masks), mesh)
    gnorm = adamw.global_norm(grads)
    new_p, new_opt, om = adamw.update(
        opt_cfg, placement.shard(grads, pspecs, mesh), state.opt,
        state.params, masks=masks, gnorm=gnorm)
    return TrainState(new_p, new_opt), om


def train_step_fn(api: ModelApi, opt_cfg: adamw.AdamWConfig, *, masks=None,
                  mesh=None):
    """The train step (state, batch) -> (state, metrics).

    ``cfg.grad_accum`` > 1 splits the batch into that many microbatches,
    runs them in order and sums their gradients in fp32, then divides by
    the count; loss and aux are the microbatches' means, so the metric
    keys are those of ``grad_accum == 1``. ``mesh``: the state is this
    rank's shard (``shard_state`` of ``state_layout``) and every rank
    passes the global batch (see the module docstring).
    """
    accum = max(api.cfg.grad_accum, 1)

    def grad_fn(params, batch):
        return value_and_grad(lambda p: api.loss(p, batch, masks=masks),
                              params)

    if mesh is None:
        def step(state: TrainState, batch) -> tuple[TrainState, dict]:
            loss, aux, grads = _accum_grads(grad_fn, state.params, batch,
                                            accum)
            new_params, new_opt, om = adamw.update(
                opt_cfg, grads, state.opt, state.params, masks=masks)
            return TrainState(new_params, new_opt), {"loss": loss, **aux,
                                                     **om}

        return step
    layout = state_layout(api, mesh)

    def mesh_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = placement.gather(state.params, layout.specs.params, mesh)
        loss, aux, grads = mesh_value_and_grad(
            api, lambda p: p, params, batch, mesh, masks=masks, accum=accum)
        del params
        new_state, om = sharded_update(opt_cfg, grads, state, layout,
                                       masks=masks)
        return new_state, {"loss": loss, **aux, **om}

    return mesh_step


def make_train_step(api: ModelApi, opt_cfg: adamw.AdamWConfig, *,
                    masks=None, mesh=None):
    """The train step with ``masks`` (and ``mesh``) bound: masks are
    static artifacts of a sparse-finetune job, not per-step inputs."""
    return train_step_fn(api, opt_cfg, masks=masks, mesh=mesh)


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
