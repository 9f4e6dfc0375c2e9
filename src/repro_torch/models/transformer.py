"""Decoder-only transformer stack, dense family.

Layout as in the reference: layer params are stacked on a leading L axis;
pruning masks mirror the stacked param tree (prunable leaves only); Gram
taps come back stacked per tap site, (L, d, d) fp32, when ``want_taps``.
Where the reference scans over layers, the port loops over them.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import common
from . import mlp as mlp_lib


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_params(cfg, device):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def _apply_norm(p, x, cfg):
    if cfg.norm == "layernorm":
        return common.layernorm(x, p["scale"], p["bias"])
    return common.rmsnorm(x, p["scale"])


def init_layer(gen, cfg, *, device) -> dict:
    return {
        "ln1": _norm_params(cfg, device),
        "attn": attn.init_attn_params(gen, cfg, device=device),
        "ln2": _norm_params(cfg, device),
        "mlp": mlp_lib.init_mlp_params(gen, cfg, device=device),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random params from a seeded ``torch.Generator`` on ``device``, with
    the reference's shapes and init scales (normal, 0.02 for embeddings,
    d_in^-0.5 for linears)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    params = {
        "embed": common.normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                    dt, device),
        "ln_f": _norm_params(cfg, device),
        "layers": _stack([init_layer(gen, cfg, device=device)
                          for _ in range(cfg.n_layers)]),
    }
    if not cfg.tie_embeddings:
        params["head"] = common.normal_init(
            gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def decoder_layer(p, x, positions, cfg, *, masks=None, taps=None):
    """One pre-norm decoder layer on unstacked params. Returns x."""
    am = None if masks is None else masks.get("attn")
    h = _apply_norm(p["ln1"], x, cfg)
    x = x + attn.self_attention(p["attn"], h, positions, cfg, masks=am,
                                taps=taps)
    h = _apply_norm(p["ln2"], x, cfg)
    mm = None if masks is None else masks.get("mlp")
    return x + mlp_lib.mlp_block(p["mlp"], h, cfg, masks=mm, taps=taps)


def forward(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    """Training/scoring forward. batch["tokens"]: (B, S) int.

    Returns (hidden (B, S, D), taps, aux). ``taps`` maps each tap name to
    {field: stacked (L, ...) tensor}; empty unless ``want_taps``.
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    m_layers = None if masks is None else masks["layers"]
    per_layer = []
    for i in range(cfg.n_layers):
        taps = common.Taps(tap_policy) if want_taps else None
        x = decoder_layer(_index(params["layers"], i), x, positions, cfg,
                          masks=_index(m_layers, i), taps=taps)
        if want_taps:
            per_layer.append(taps.entries)
    x = _apply_norm(params["ln_f"], x, cfg)
    taps = _stack(per_layer) if per_layer else {}
    return x, taps, torch.zeros((), device=x.device)


def lm_head(params, hidden, cfg):
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return hidden @ head.T.to(hidden.dtype)


def ce_loss(params, hidden, labels, cfg):
    """Mean cross-entropy over the valid (label >= 0) tokens."""
    tot, cnt = _ce_sums(params, hidden, labels, cfg)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(params, hidden, labels, cfg):
    logits = lm_head(params, hidden, cfg).float()
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.float().sum()


def loss_fn(params, batch, cfg, *, masks=None, want_taps=False,
            tap_policy: common.TapPolicy | None = None):
    hidden, taps, aux = forward(params, batch, cfg, masks=masks,
                                want_taps=want_taps, tap_policy=tap_policy)
    loss = ce_loss(params, hidden, batch["labels"], cfg)
    return loss + aux, {"ce": loss, "aux": aux, "taps": taps}
