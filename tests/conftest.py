"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 device;
multi-device tests (test_distributed.py) spawn subprocesses instead."""
import numpy as np
import pytest
import jax.numpy as jnp


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess lower+compile)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_problem(rng, d_out=16, d_in=48, B=200, corr=0.3, seed=None):
    """A correlated-feature layer problem (W, X, G)."""
    if seed is not None:
        rng = np.random.default_rng(seed)
    X = rng.normal(size=(d_in, B)).astype(np.float32)
    M = np.eye(d_in) + corr * rng.normal(size=(d_in, d_in))
    X = (M @ X).astype(np.float32)
    W = rng.normal(size=(d_out, d_in)).astype(np.float32)
    G = jnp.asarray(X @ X.T)
    return jnp.asarray(W), jnp.asarray(X), G
