"""Synthetic Zipf–Markov language — the offline C4 stand-in.

The same statistics as the reference corpus: K latent topics, each with
its own Zipf-permuted emission distribution over V tokens; topics persist
with probability ``stickiness``. Heavy-tailed unigrams give the
activation outliers Wanda exploits; topic persistence gives correlated
features (off-diagonal Gram mass), which separates SparseSwaps from the
diagonal bound.

The reference samples with ``jax.random`` (threefry), which torch cannot
reproduce: this sampler draws from seeded ``torch.Generator``s, so its
tokens differ from the reference's. Parity tests feed the reference's
token arrays to both packages instead. Batches are keyed by
(seed, split, step, host), so a restarted job replays identical batches.

``with_modality`` attaches the stub frontend embeddings of the
cross-attention families (a VLM's ``img``, an encoder-decoder's
``src``), keyed by (seed, modality, step), drawn on the batch's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SPLITS = {"train": 0, "calib": 1, "val": 2}


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab_size: int
    n_topics: int = 8
    zipf_a: float = 1.2
    stickiness: float = 0.95
    seed: int = 0


def _generator(*key: int, device="cpu") -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def emission_probs(cfg: CorpusConfig) -> torch.Tensor:
    """(K, V) topic emission probabilities: Zipf magnitudes, per-topic
    permutation of the token ranks."""
    ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    zipf = ranks ** -cfg.zipf_a
    gen = _generator(cfg.seed, 99)
    perms = torch.stack([torch.randperm(cfg.vocab_size, generator=gen)
                         for _ in range(cfg.n_topics)])
    probs = zipf[perms]
    return probs / probs.sum(1, keepdim=True)


def sample_batch(cfg: CorpusConfig, gen: torch.Generator, batch: int,
                 seq: int, probs: torch.Tensor | None = None) -> torch.Tensor:
    """(batch, seq+1) int64 token stream (inputs = [:, :-1], labels = [:, 1:])."""
    probs = emission_probs(cfg) if probs is None else probs
    n = seq + 1
    topic = torch.randint(cfg.n_topics, (batch,), generator=gen)
    switch = torch.rand((n, batch), generator=gen) > cfg.stickiness
    fresh = torch.randint(cfg.n_topics, (n, batch), generator=gen)
    topics = torch.empty((n, batch), dtype=torch.int64)
    for t in range(n):
        topic = torch.where(switch[t], fresh[t], topic)
        topics[t] = topic
    toks = torch.empty((n, batch), dtype=torch.int64)
    for k in range(cfg.n_topics):
        sel = topics == k
        cnt = int(sel.sum())
        if cnt:
            toks[sel] = torch.multinomial(probs[k], cnt, replacement=True,
                                          generator=gen)
    return toks.T.contiguous()


class DataPipeline:
    """Stateless iterator facade over the keyed sampler."""

    def __init__(self, cfg: CorpusConfig, batch: int, seq: int,
                 split: str = "train", host: int = 0, device="cpu"):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.split, self.host = split, host
        self.device = torch.device(device)
        self._probs = emission_probs(cfg)

    def get(self, step: int) -> dict:
        gen = _generator(self.cfg.seed, _SPLITS[self.split], step, self.host)
        toks = sample_batch(self.cfg, gen, self.batch, self.seq,
                            self._probs).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_MODALITY = {"img": 7, "src": 8}       # the reference's fold_in tags


def with_modality(batch: dict, cfg_arch, seed: int, step: int) -> dict:
    """``batch`` plus the stub frontend embeddings its architecture reads:
    a VLM's ``img`` (B, n_img_tokens, d_frontend or d_model), an
    encoder-decoder's ``src`` (B, n_src_frames, ...); other architectures'
    batches come back unchanged. Values are 0.02 · N(0, 1) in the
    config's dtype, from a generator keyed by (seed, modality, step) on
    the tokens' device (the reference draws with ``jax.random``, so the
    values differ: parity tests feed the reference's arrays to both)."""
    out = dict(batch)
    tokens = batch["tokens"]
    B, dev = tokens.shape[0], tokens.device
    d = cfg_arch.d_frontend or cfg_arch.d_model
    want = {}
    if cfg_arch.cross_attn_every:
        want["img"] = cfg_arch.n_img_tokens
    if cfg_arch.is_encdec:
        want["src"] = cfg_arch.n_src_frames
    for key, n in want.items():
        gen = _generator(seed, _MODALITY[key], step, device=dev)
        x = torch.randn((B, n, d), generator=gen, device=dev)
        out[key] = (0.02 * x).to(getattr(torch, cfg_arch.dtype))
    return out
