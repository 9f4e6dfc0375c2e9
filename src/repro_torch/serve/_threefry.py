"""Threefry-2x32 on torch tensors, bit-exact with JAX's default PRNG.

The reference samples with ``jax.random`` under ``threefry2x32`` in the
partitionable bit layout (``jax_threefry_partitionable``): the key of a
seed is ``(0, seed)``, ``fold_in(key, d)`` is ``threefry(key, (0, d))``,
and the bits of a (V,) draw are ``x0 ^ x1`` of ``threefry(key, (0, i))``
over the counter ``i = 0 .. V-1`` (the 64-bit linear index split into two
32-bit words; its high word is 0 below 2**32 draws). A uniform in
[tiny, 1) keeps the top 23 bits as the mantissa of a float in [1, 2),
subtracts 1 and clamps at ``finfo(float32).tiny``; the Gumbel noise is
``-log(-log(u))``.

torch's uint32 arithmetic is partial, so every word is an int64 holding
a value in [0, 2**32) and sums are masked back to 32 bits. Everything is
tensor ops on the input's device: a batch of keys draws its bits without
a host round trip.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000              # float32 1.0
_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of counters (x0, x1) under key
    (k0, k1); int64 words in [0, 2**32), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def seed_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)`` of uint32 seeds: the key words (0, seed)."""
    s = seed.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(key, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` for uint32 ``data``, elementwise
    over a batch of keys."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key, n: int) -> torch.Tensor:
    """(B, n) 32-bit draws of a batch of B keys (each word (B,)), as
    ``jax.random.bits(key, (n,))`` gives them per key."""
    k0, k1 = key[0][:, None], key[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return x0 ^ x1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [tiny, 1) from 32-bit draws, as
    ``jax.random.uniform(key, minval=tiny, maxval=1.0)`` makes them."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """The reference's low-range Gumbel noise, -log(-log(u))."""
    return -torch.log(-torch.log(uniform(bits)))
