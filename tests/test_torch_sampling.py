"""The port's sampler against the reference's ``serve.sampling``.

* Threefry-2x32: the folded keys ``fold_in(key(seed), t)`` and the 32-bit
  draws ``jax.random.bits`` gives for them are bitwise equal to the
  port's, for a grid of seeds (0, small, 2**31 and up, 2**32 - 1) and
  positions; the uniforms in [tiny, 1) are bitwise equal too.
* The Gumbel noise -log(-log(u)) is within 4 ulp of max(|g|, 1) of the
  reference's (XLA's CPU ``log`` and torch's are different
  implementations; 2 such ulp is the most seen).
* ``sample_tokens`` over the reference test's knob grid (greedy,
  temperature, top-k, top-p, their mixes, per-row seeds and positions)
  gives the reference's tokens wherever the two best perturbed scores of
  the port differ by more than ``MARGIN`` and no token's preceding
  nucleus mass lies within ``MASS_MARGIN`` of its top_p (softmax and
  cumsum in another order move a boundary only there).
* The reference test's invariants (T=0 is argmax, top-k restricts,
  nucleus collapse, seeded determinism), the host-side greedy shortcut,
  ``validate`` and ``parse_sample_flag``; and sampled ``generate`` on tiny
  llama31-8b against the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import sampling as jsampling  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.serve import ServeEngine, _threefry  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402

SEEDS = (0, 1, 7, 123456, 2**31 + 5, 2**32 - 1)
POSITIONS = (0, 1, 5, 100, 2047, 65535)
GUMBEL_ULPS = 4          # of max(|g|, 1)
MARGIN = 1e-4            # perturbed-score gap below which tokens may part
MASS_MARGIN = 1e-5       # nucleus-mass distance from top_p, likewise
TINY = np.finfo(np.float32).tiny


def _ref_key(seed, t):
    return jax.random.fold_in(jax.random.key(np.uint32(seed)), t)


def _port_key(seed, t):
    return _threefry.fold_in(_threefry.seed_key(torch.tensor([seed])),
                             torch.tensor([t]))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_bits_and_uniforms_match_jax(seed):
    for t in POSITIONS:
        k = _ref_key(seed, t)
        want = np.asarray(jax.random.key_data(k)).astype(np.int64)
        got = _port_key(seed, t)
        assert [int(got[0][0]), int(got[1][0])] == want.tolist(), (seed, t)
        bits = _threefry.random_bits(got, 3000)[0]
        ref_bits = np.asarray(jax.random.bits(k, (3000,), jnp.uint32))
        assert np.array_equal(bits.numpy().astype(np.uint32), ref_bits)
        ref_u = np.asarray(jax.random.uniform(k, (3000,), jnp.float32,
                                              minval=TINY, maxval=1.0))
        assert np.array_equal(_threefry.uniform(bits).numpy(), ref_u)


def test_batched_keys_match_one_at_a_time():
    seeds = torch.tensor(SEEDS[:4])
    ts = torch.tensor(POSITIONS[:4])
    bits = _threefry.random_bits(
        _threefry.fold_in(_threefry.seed_key(seeds), ts), 64)
    for i, (s, t) in enumerate(zip(SEEDS[:4], POSITIONS[:4])):
        assert torch.equal(bits[i], _threefry.random_bits(
            _port_key(s, t), 64)[0])


def test_gumbel_within_ulps_of_jax():
    worst = 0.0
    for seed in range(12):
        for t in (0, 3, 77, 4000):
            k = _ref_key(seed, t)
            want = np.asarray(jax.random.gumbel(k, (20000,), jnp.float32))
            got = _threefry.gumbel(
                _threefry.random_bits(_port_key(seed, t), 20000)[0]).numpy()
            ulp = np.spacing(np.maximum(np.abs(want), 1.0)).astype(np.float64)
            worst = max(worst, float((np.abs(got.astype(np.float64) - want)
                                      / ulp).max()))
    assert worst <= GUMBEL_ULPS, worst


KNOBS = [  # (temp, top_p, top_k): the reference test's grid and mixes
    (0.0, 1.0, 0), (2.0, 1.0, 1), (3.0, 1.0, 8), (1.5, 1.0, 0),
    (1.0, 0.5, 0), (0.8, 0.9, 0), (1.2, 0.9, 32), (0.7, 0.95, 40),
]


def test_sampled_tokens_match_reference():
    rng = np.random.default_rng(3)
    B, V = 8, 257
    compared = total = 0
    for trial in range(30):
        logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        knobs = [KNOBS[(trial + b) % len(KNOBS)] for b in range(B)]
        temp = np.array([k[0] for k in knobs], np.float32)
        top_p = np.array([k[1] for k in knobs], np.float32)
        top_k = np.array([k[2] for k in knobs], np.int32)
        seed = rng.integers(0, 2**32, size=B).astype(np.uint32)
        t = rng.integers(0, 5000, size=B).astype(np.int32)
        want = np.asarray(jsampling.sample_tokens(
            *map(jnp.asarray, (logits, temp, top_p, top_k, seed, t))))
        args = [torch.from_numpy(a) for a in (logits, temp, top_p)] + \
            [torch.from_numpy(a.astype(np.int64)) for a in (top_k, seed, t)]
        got = sampling.sample_tokens(*args).numpy()
        scores, _, before = sampling.perturbed_scores(*args)
        near = ((before - args[2][:, None]).abs() < MASS_MARGIN).any(-1) \
            & (args[2] < 1.0)
        top2 = torch.topk(scores, 2, dim=-1).values
        clear = ((top2[:, 0] - top2[:, 1]) > MARGIN) & ~near
        clear |= torch.from_numpy(temp <= 0)           # greedy rows: argmax
        total += B
        compared += int(clear.sum())
        sel = clear.numpy()
        assert np.array_equal(got[sel], want[sel]), (trial, got, want)
    assert compared >= 0.95 * total, (compared, total)


def _draw(logits, **kw):
    B = logits.shape[0]
    return sampling.sample_tokens(
        logits, torch.full((B,), kw.get("temp", 0.0)),
        torch.full((B,), kw.get("top_p", 1.0)),
        torch.full((B,), kw.get("top_k", 0)),
        torch.full((B,), kw.get("seed", 0)), torch.arange(B))


def test_sampling_greedy_and_knobs():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    want = torch.argmax(logits, dim=-1)
    assert torch.equal(_draw(logits), want)                # T=0 is argmax
    assert torch.equal(_draw(logits, temp=2.0, top_k=1), want)
    top8 = torch.argsort(-logits, dim=-1)[:, :8]
    for seed in range(8):                # top-k restricts every draw
        got = _draw(logits, temp=3.0, top_k=8, seed=seed)
        assert all(int(got[b]) in top8[b].tolist() for b in range(4))
    # a nucleus smaller than the top token's mass collapses to argmax
    peaked = torch.zeros(2, 16)
    peaked[:, 5] = 10.0
    got = sampling.sample_tokens(peaked, torch.ones(2), torch.full((2,), 0.5),
                                 torch.zeros(2, dtype=torch.int64),
                                 torch.tensor([7, 9]),
                                 torch.zeros(2, dtype=torch.int64))
    assert got.tolist() == [5, 5]
    # seeded draws are deterministic, and seeds decorrelate
    a = [_draw(logits, temp=1.5, seed=11) for _ in range(2)]
    assert torch.equal(a[0], a[1])
    others = torch.stack([_draw(logits, temp=1.5, seed=s)
                          for s in range(20, 40)])
    assert (others != a[0]).any()


def test_greedy_shortcut_equals_full_path():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32))
    samp = sampling.params_arrays([SamplingParams()] * 5)
    assert samp["greedy"]
    full = sampling.sample_tokens(logits, samp["temp"], samp["top_p"],
                                  samp["top_k"], samp["seed"], 9)
    assert torch.equal(sampling.sample(logits, samp, 9), full)
    mixed = sampling.params_arrays(
        [SamplingParams(), SamplingParams(temperature=0.9, seed=3)])
    assert not mixed["greedy"]
    got = sampling.sample(logits[:2], mixed, torch.tensor([4, 4]))
    assert int(got[0]) == int(torch.argmax(logits[0]))


def test_sampling_validate_and_flag_parsing():
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-1.0).validate()
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0).validate()
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1).validate()
    with pytest.raises(ValueError, match="empty"):
        sampling.parse_sample_flag(" , ")
    s = sampling.parse_sample_flag("0.8,0.9,40")
    assert (s.temperature, s.top_p, s.top_k) == (0.8, 0.9, 40)
    s = sampling.parse_sample_flag("0.5")
    assert (s.temperature, s.top_p, s.top_k) == (0.5, 1.0, 0)
    with pytest.raises(ValueError):
        sampling.parse_sample_flag("0.5,1.5")


def test_generate_sampled_matches_reference():
    """Fixed-batch ``generate`` with per-row sampling on tiny llama31-8b
    (fp32, the reference's params): the reference's tokens."""
    cfg = jconfigs.get_tiny("llama31-8b")
    japi = jmodels.build(cfg)
    jparams = japi.init(jax.random.key(0))
    tapi = tmodels.build(tconfigs.get_tiny("llama31-8b"))
    tparams = convert.from_numpy(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(5).integers(0, 256, size=(3, 8))
    rows = [(0.0, 1.0, 0, 0), (0.8, 0.95, 40, 3), (1.3, 0.9, 0, 2**31 + 1)]
    jrows = [jsampling.SamplingParams(*r) for r in rows]
    trows = [SamplingParams(*r) for r in rows]
    want = JServeEngine(japi, jparams, fmt="dense").generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, 6, sampling=jrows).tokens
    got = ServeEngine(tapi, tparams, fmt="dense", device="cpu").generate(
        {"tokens": torch.from_numpy(toks)}, 6, sampling=trows).tokens
    assert np.array_equal(got.numpy(), np.asarray(want))
