"""Continuous serving of the port's MoE family (mixtral-8x7b,
granite-moe-3b-a800m) against the reference, on their TINYs (fp32, params
from the reference through ``convert``).

* ``supports_continuous`` is True for MoE, as in the reference
  (``src/repro/serve/engine.py``), and False where the reference refuses:
  another model module, a cross-attention config.
* The reference's ``ContinuousScheduler`` and the port's, step for step
  (``_torch_serve_pair``): plain, chunked at W = 4 and 8, disaggregated,
  and a fault plan (pool exhaustion, a failed ship, a slow step and a
  SIGTERM, disaggregated with W = 8). Tokens, per-step events, pool bytes,
  counters, fired faults and shape keys are equal.
* Chunked prefill against one-shot prefill. A W-token window dispatches
  its tokens with capacity(W), one-shot prefill with capacity(S_bucket).
  Where no group drops (capacity_factor = E / top_k, so capacity(G) = G:
  every expert could take the whole group) the two are the same function
  and agree to rounding, in both packages. At the configs' own factor
  (1.25) the W = 4 windows drop assignments (counted by
  ``models.moe.count_drops``): chunked and one-shot then compute
  different functions, and they differ in both packages alike, while the
  port's chunked prefill gives the reference's chunked K, V and token.
* Batched == solo bitwise at the pinned width: decode dispatches one
  token a row with capacity(1), so no row competes with another for a
  slot; evict -> resume bitwise.
* ``decode_chunk`` reads nothing back to the host on an MoE model, with
  drops being counted.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

import _torch_serve_pair as pair  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import serve as jserve  # noqa: E402

from repro_torch import models as tmodels  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import (GREEDY, SamplingParams,  # noqa: E402
                               ServeEngine, sampling)

MOE = ["mixtral-8x7b", "granite-moe-3b-a800m"]
_prompt = pair.prompt


@pytest.fixture(scope="module", params=MOE)
def world(request):
    return pair.build_world(request.param)


@pytest.fixture(scope="module")
def engine(world):
    return world["engines"][pair.PORT]


def _sched(engine, **kw):
    return pair.sched(pair.PORT, engine, **kw)


def test_supports_continuous_like_reference(world):
    port, ref = world["engines"][pair.PORT], world["engines"][pair.REF]
    assert port.supports_continuous and ref.supports_continuous
    prop = ServeEngine.supports_continuous.fget
    other = types.SimpleNamespace(api=types.SimpleNamespace(module=object()),
                                  cfg=port.cfg)
    vlm = types.SimpleNamespace(api=port.api, cfg=types.SimpleNamespace(
        cross_attn_every=4))
    assert not prop(other) and not prop(vlm)
    jprop = jserve.ServeEngine.supports_continuous.fget
    assert not jprop(types.SimpleNamespace(
        api=types.SimpleNamespace(module=object()), cfg=ref.cfg))
    assert not jprop(types.SimpleNamespace(api=ref.api,
                                           cfg=types.SimpleNamespace(
                                               cross_attn_every=4)))


# -- against the reference scheduler -------------------------------------------

WORKLOAD = [
    (_prompt(13, seed=1), 6, {}, {}),
    (_prompt(5, seed=2), 3, {"temperature": 0.8, "seed": 4}, {}),
    (_prompt(14, seed=3), 7, {"temperature": 1.1, "top_p": 0.9, "top_k": 32,
                              "seed": 5}, {}),
    (_prompt(8, seed=4), 1, {}, {}),
    (_prompt(11, seed=5), 9, {}, {}),
    (_prompt(6, seed=6), 5, {"temperature": 0.6, "seed": 6}, {}),
]
TRAFFIC = [(_prompt(3 + (5 * i) % 12, seed=40 + i), 6 + (7 * i) % 10,
            ({}, {"temperature": 0.9, "top_p": 0.95, "seed": 11})[i % 2], {})
           for i in range(12)]
FAULTS = dict(exhaust_pool_at=(3, 6), fail_ship=(2,), slow_steps=((4, 0.001),),
              sigterm_at=9)
SCENARIOS = {
    "plain": (WORKLOAD, dict(per_step=2)),
    "chunked-W4": (WORKLOAD, dict(per_step=2, prefill_chunk=4)),
    "chunked-W8": (WORKLOAD, dict(per_step=2, prefill_chunk=8)),
    "disaggregated": (WORKLOAD, dict(per_step=2, disaggregate=True,
                                     bucket_batch=False)),
    "faults-disaggregated-W8": (TRAFFIC, dict(
        per_step=1, faults=FAULTS, disaggregate=True, prefill_chunk=8)),
}


@pytest.fixture(scope="module")
def pairs(world):
    return {name: pair.run_pair(world, reqs, **kw)
            for name, (reqs, kw) in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_reference(pairs, name):
    pair.assert_same(pairs[name])
    port = pairs[name][pair.PORT]
    reqs = SCENARIOS[name][0]
    if name.startswith("faults"):
        assert {k for _, k in port["fired"]} >= {"exhaust", "ship",
                                                 "sigterm", "slow"}
        assert port["drained"] and 0 < len(port["done"]) < len(reqs)
    else:
        assert set(port["done"]) == set(range(len(reqs)))
    if "disaggregated" in name:
        assert port["shipped"] > 0


# -- chunked prefill vs one-shot ----------------------------------------------


def _prefills(engine, padded, S, W, samp, to_tensor):
    """(one-shot tok0, K, V; chunked tok0, K, V) of one package's engine,
    K and V over the S valid positions of every layer, as numpy."""
    tok_a, k_a, v_a = engine.prefill_session(to_tensor(padded), S, samp)
    cache = engine.api.init_cache(engine.params, 1, padded.shape[1])
    for off in range(0, S, W):
        tok_b, cache = engine.prefill_chunk(
            to_tensor(padded[:, off:off + W]), off, S, cache, samp)
    np_ = lambda t: np.asarray(t, np.float32)  # noqa: E731
    return ((np_(tok_a), np_(k_a[:, :S]), np_(v_a[:, :S])),
            (np_(tok_b), np_(cache.kv.k[:, 0, :S]), np_(cache.kv.v[:, 0, :S])))


def _dmax(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a[1:], b[1:]))


@pytest.mark.parametrize("drops", [False, True], ids=["no-drops", "drops"])
def test_prefill_chunk_vs_one_shot(world, drops):
    """W = 4 windows of a 13-token prompt against one prefill over the
    16-token bucket, in both packages. No drops: equal to rounding. Drops:
    the two prefills differ (far beyond rounding) in both packages, and
    each package's chunked and one-shot results are the other's."""
    cfg = world["cfg"]
    if drops:
        ref_eng = world["engines"][pair.REF]
        port_eng = world["engines"][pair.PORT]
    else:
        cf = cfg.n_experts / cfg.top_k        # capacity(G) = G
        ref_eng = jserve.ServeEngine(
            jmodels.build(world["japi"].cfg.replace(capacity_factor=cf)),
            world["jparams"], fmt="dense")
        port_eng = ServeEngine(tmodels.build(cfg.replace(capacity_factor=cf)),
                               world["params"], fmt="dense", device="cpu")
    S, W = 13, 4
    padded = np.zeros((1, 16), np.int32)
    padded[0, :S] = _prompt(S, seed=11)
    knobs = SamplingParams(temperature=0.9, top_p=0.9, seed=7)
    with tmoe.count_drops() as cnt:
        port = _prefills(port_eng, padded, S, W,
                         sampling.params_arrays([knobs]),
                         lambda a: torch.from_numpy(a.astype(np.int64)))
    ref = _prefills(ref_eng, padded, S, W,
                    jserve.sampling.params_arrays([jserve.SamplingParams(
                        temperature=0.9, top_p=0.9, seed=7)]),
                    lambda a: a)
    # the port's prefills are the reference's, one-shot and chunked
    for got, want in zip(port, ref):
        assert _dmax(got, want) <= 1e-5 and np.array_equal(got[0], want[0])
    one_port, chunk_port = port
    one_ref, chunk_ref = ref
    if not drops:
        assert cnt.total() == 0 and cnt.assignments > 0
        assert _dmax(one_port, chunk_port) <= 1e-5
        assert _dmax(one_ref, chunk_ref) <= 1e-5
        assert np.array_equal(one_port[0], chunk_port[0])
    else:
        assert cnt.total() > 0, "the W = 4 windows dropped nothing"
        # chunked != one-shot where groups drop: a different function
        assert _dmax(one_port, chunk_port) > 1e-3
        assert _dmax(one_ref, chunk_ref) > 1e-3


# -- batched == solo, evict -> resume -----------------------------------------

REQS = [
    (_prompt(7, seed=1), 6, GREEDY),
    (_prompt(12, seed=2), 9, SamplingParams(temperature=0.8, seed=4)),
    (_prompt(5, seed=3), 3, SamplingParams(temperature=1.2, top_p=0.9,
                                           top_k=32, seed=5)),
    (_prompt(9, seed=4), 7, GREEDY),
]


def _solo(engine, prompt, n_new, samp):
    sch = _sched(engine, bucket_batch=False)
    rid = sch.submit(prompt, n_new, sampling=samp)
    return sch.run_until_idle()[rid].tokens


def test_batched_equals_solo_bitwise(engine):
    sch = _sched(engine, bucket_batch=False)
    rids = [sch.submit(p, n, sampling=s) for p, n, s in REQS]
    done = sch.run_until_idle()
    assert sch.pool.used_bytes == 0
    for rid, (p, n, s) in zip(rids, REQS):
        np.testing.assert_array_equal(done[rid].tokens, _solo(engine, p, n, s))


def test_evict_resume_mid_decode_bitwise(engine):
    reqs = [(_prompt(6, seed=1), 12), (_prompt(9, seed=2), 10)]
    want = [_solo(engine, p, n, GREEDY) for p, n in reqs]
    sch = _sched(engine, bucket_batch=False)
    rids = [sch.submit(p, n) for p, n in reqs]
    for _ in range(2):
        sch.step()
    assert len(sch.slots) == 2 and sch._evict_row_lru()
    done = sch.run_until_idle()
    assert sch.counters["evict_resumed"] == 1 and sch.pool.used_bytes == 0
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(done[rid].tokens, w)


def test_decode_chunk_reads_nothing_back(engine, monkeypatch):
    """An MoE decode chunk (router, sort, dispatch, combine per layer,
    drops counted) copies no device value to the host."""
    sch = _sched(engine, bucket_batch=False)
    sch.submit(_prompt(6, seed=1), 3, sampling=SamplingParams(
        temperature=0.9, top_k=5, seed=1))
    sch.submit(_prompt(9, seed=2), 3)
    ev = pair.PORT.StepEvents([], {}, [], 0, 0)
    sch._prefill_one(ev)
    sch._prefill_one(ev)
    sch._join_ready(ev)
    active = torch.arange(sch.max_batch) < len(sch.slots)
    samp = sch._samp_tensors(len(sch.slots))

    def host_read(*a, **k):
        raise AssertionError("host read inside decode_chunk")

    with tmoe.count_drops() as cnt:
        for name in ("item", "tolist", "numpy", "__int__", "__float__",
                     "__bool__", "__index__"):
            monkeypatch.setattr(torch.Tensor, name, host_read)
        toks, _ = engine.decode_chunk(sch._toks, sch.cache, active, samp,
                                      n_steps=4, bucket=4)
        monkeypatch.undo()
    assert toks.shape == (4, 4)
    # decode: capacity(1) = 1 slot an expert, top-k experts distinct
    assert cnt.total() == 0
    assert cnt.assignments == 4 * 4 * engine.cfg.n_layers * engine.cfg.top_k
