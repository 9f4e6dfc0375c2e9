"""Disaggregated serving in the port: chunked prefill, page shipping, the
two-lane scheduler — against the reference and on its own invariants.

* The same workload through the reference's scheduler and the port's:
  equal tokens, per-step events, pool bytes, counters and shape keys for
  chunked prefill at W = 2, 4, 8 and 16, and disaggregated (two pools,
  page shipping) with and without a chunked window.
* The invariants of the reference's ``test_serve_disagg.py`` on the port.
  Its first contract, chunked prefill bitwise equal to one-shot prefill,
  holds here at W = 8 and 16 only: torch's CPU matmul (MKL) rounds a
  product of 1 or 2 rows (up to 4 at K = 96, tiny llama31-8b's w_down)
  otherwise than the same rows inside a larger product, so the W = 2 and
  W = 4 windows' K and V differ from one-shot prefill by ~1e-6 (fp32).
  Those widths are held to equal tokens and K/V within 1e-5 instead
  (ROADMAP queue C). Token streams stay equal across widths and modes.
* Meshes are not ported (A5).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_serve_pair as pair  # noqa: E402

from repro_torch.serve import (PagedKVCache, SamplingParams,  # noqa: E402
                               loadgen, sampling)
from repro_torch.serve.kvcache import ship_pages  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_prompt = pair.prompt


@pytest.fixture(scope="module")
def world():
    return pair.build_world()


@pytest.fixture(scope="module")
def engine(world):
    return world["engines"][pair.PORT]


def _sched(engine, **kw):
    return pair.sched(pair.PORT, engine, **kw)


# -- against the reference scheduler -------------------------------------------

WORKLOAD = [
    (_prompt(13, seed=1), 6, {}, {}),
    (_prompt(5, seed=2), 3, {"temperature": 0.8, "seed": 4}, {}),
    (_prompt(29, seed=3), 7, {"temperature": 1.1, "top_p": 0.9, "top_k": 32,
                              "seed": 5}, {}),
    (_prompt(8, seed=4), 1, {}, {}),
    (_prompt(30, seed=5), 9, {}, {}),
    (_prompt(17, seed=6), 5, {"temperature": 0.6, "seed": 6}, {}),
]
SCENARIOS = {
    **{f"chunked-W{w}": dict(prefill_chunk=w) for w in (2, 4, 8, 16)},
    "disaggregated": dict(disaggregate=True, bucket_batch=False),
    "disaggregated-W8": dict(disaggregate=True, prefill_chunk=8),
}


@pytest.fixture(scope="module")
def pairs(world):
    return {name: pair.run_pair(world, WORKLOAD, per_step=2, **kw)
            for name, kw in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_reference(pairs, name):
    pair.assert_same(pairs[name])
    port = pairs[name][pair.PORT]
    assert set(port["done"]) == set(range(len(WORKLOAD)))
    if "disaggregated" in name:
        assert port["shipped"] > 0


# -- chunked prefill vs one-shot ----------------------------------------------


@pytest.mark.parametrize("W", (2, 4, 8, 16))
def test_prefill_chunk_equals_one_shot(world, engine, W):
    """The stored KV of every valid position and the first sampled token
    of ⌈S/W⌉ windows against one ``prefill_session`` over the same
    bucket: bitwise at W = 8, 16; at W = 2, 4 torch's CPU matmul breaks
    the reference's bitwise contract (module docstring), so equal tokens
    and K/V within 1e-5."""
    api = world["api"]
    S, s_bucket = 13, 16
    padded = np.zeros((1, s_bucket), np.int64)
    padded[0, :S] = _prompt(S, seed=11)
    samp = sampling.params_arrays(
        [SamplingParams(temperature=0.9, top_p=0.9, seed=7)])
    tok_ref, k_ref, v_ref = engine.prefill_session(
        torch.from_numpy(padded), S, samp)
    cache = api.init_cache(engine.params, 1, s_bucket)
    off = 0
    while off < S:
        tok, cache = engine.prefill_chunk(
            torch.from_numpy(padded[:, off:off + W]), off, S, cache, samp)
        off += W
    k, v = cache.kv.k[:, 0, :S], cache.kv.v[:, 0, :S]
    assert torch.equal(tok, tok_ref)
    assert int(cache.t) == S
    assert cache.kv.pos[0, 0].tolist() == \
        [i if i < S else -1 for i in range(s_bucket)]
    if W >= 8:
        assert torch.equal(k, k_ref[:, :S]) and torch.equal(v, v_ref[:, :S])
    else:
        torch.testing.assert_close(k, k_ref[:, :S], rtol=0, atol=1e-5)
        torch.testing.assert_close(v, v_ref[:, :S], rtol=0, atol=1e-5)
    assert ("prefill_chunk", W, s_bucket) in engine.compiled_fn_keys()


def test_chunked_scheduler_streams_equal_across_widths(engine):
    reqs = [(p, n, pair.PORT.SamplingParams(**k)) for p, n, k, _ in
            WORKLOAD[:4]]

    def run(**kw):
        sch = _sched(engine, bucket_batch=False, **kw)
        rids = [sch.submit(p, n, sampling=s) for p, n, s in reqs]
        done = sch.run_until_idle()
        assert sch.pool.used_bytes == 0
        if sch.prefill_pool is not None:
            assert sch.prefill_pool.used_bytes == 0
        return [done[r].tokens.tolist() for r in rids]

    want = run()
    for kw in (dict(prefill_chunk=4), dict(prefill_chunk=16),
               dict(disaggregate=True),
               dict(disaggregate=True, prefill_chunk=8)):
        assert run(**kw) == want, f"stream differs for {kw}"


def test_disaggregated_ships_real_bytes(engine):
    sch = _sched(engine, disaggregate=True, prefill_chunk=4)
    rid = sch.submit(_prompt(12, seed=9), 5)
    done = sch.run_until_idle()
    assert done[rid].n_new == 5
    # 12 prompt tokens = 2 pages of 8 crossed the pools exactly once
    assert sch.shipped_bytes == 2 * sch.pool.page_bytes
    assert sch.prefill_pool.shipped_bytes_out == sch.shipped_bytes
    assert sch.prefill_pool.used_bytes == 0 and sch.pool.used_bytes == 0


def test_prefill_chunk_rejects_bad_widths(engine):
    with pytest.raises(ValueError, match="power of two"):
        _sched(engine, prefill_chunk=6)
    with pytest.raises(NotImplementedError, match="A5"):
        _sched(engine, disaggregate=True, decode_mesh=object())


# -- ship_pages ---------------------------------------------------------------


def _rows(cfg, seed, n=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n, cfg.n_kv_heads, cfg.head_dim)
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
            torch.from_numpy(rng.normal(size=shape).astype(np.float32)))


def test_ship_pages_roundtrip_and_accounting(world):
    cfg = world["cfg"]
    src = PagedKVCache(cfg, n_pages=8, page_size=4)
    dst = PagedKVCache(cfg, n_pages=8, page_size=4)
    k, v = _rows(cfg, 3)
    src.alloc("s", 11)                       # 3 pages
    src.store("s", k, v, 11)
    moved = ship_pages(src, dst, "s", capacity=16)
    assert moved == 3 * src.page_bytes
    assert src.shipped_bytes_out == dst.shipped_bytes_in == moved
    assert "s" not in src.sessions() and src.used_bytes == 0
    got_k, got_v, pos, length = dst.load("s", 16)
    assert length == 11
    assert torch.equal(got_k[:, :11], k[:, :11])
    assert torch.equal(got_v[:, :11], v[:, :11])
    assert pos.tolist() == [i if i < 11 else -1 for i in range(16)]


def test_ship_pages_dst_full_rolls_back(world):
    cfg = world["cfg"]
    src = PagedKVCache(cfg, n_pages=4, page_size=4)
    dst = PagedKVCache(cfg, n_pages=4, page_size=4)
    dst.alloc("hog", 12)                     # 3 of 4 pages taken
    src.alloc("s", 9)                        # needs 3 pages at dst
    src.store("s", *_rows(cfg, 4), 9)
    with pytest.raises(MemoryError, match="exhausted"):
        ship_pages(src, dst, "s", capacity=16)
    assert "s" in src.sessions() and src.length("s") == 9
    assert dst.sessions() == ["hog"]
    assert src.shipped_bytes_out == 0 and dst.shipped_bytes_in == 0
    dst.free("hog")
    assert ship_pages(src, dst, "s", capacity=16) == 3 * src.page_bytes


def test_ship_pages_page_size_mismatch(world):
    cfg = world["cfg"]
    src = PagedKVCache(cfg, n_pages=4, page_size=4)
    dst = PagedKVCache(cfg, n_pages=4, page_size=8)
    src.alloc("s", 4)
    with pytest.raises(ValueError, match="page-size mismatch"):
        ship_pages(src, dst, "s", capacity=16)


# -- admission window (head-of-line blocking) ---------------------------------


def test_small_request_overtakes_page_starved_head(engine):
    sch = _sched(engine, n_pages=8, prefill_budget=1, decode_chunk=1)
    a = sch.submit(_prompt(8, seed=0), 24)   # 32 tokens = 4 pages
    sch.step()                               # A active, 4 pages free
    big = sch.submit(_prompt(24, seed=1), 16)   # 5 pages: starved
    small = sch.submit(_prompt(8, seed=2), 4)   # 2 pages: fits
    ev = sch.step()
    assert small in ev.prefill_started and big not in ev.prefill_started
    assert sch.queue and sch.queue[0].rid == big
    done = sch.run_until_idle()
    assert set(done) >= {a, big, small}
    assert done[big].n_new == 16
    assert sch.pool.used_bytes == 0


def test_admission_stays_fifo_when_unstarved(engine):
    sch = _sched(engine, prefill_budget=1, decode_chunk=1)
    rids = [sch.submit(_prompt(6, seed=s), 2) for s in range(4)]
    order = []
    while not sch.idle:
        order.extend(sch.step().prefill_started)
    assert order == rids


def test_starved_beyond_window_waits(engine):
    sch = _sched(engine, n_pages=8, admit_window=2, prefill_budget=1,
                 decode_chunk=1)
    sch.submit(_prompt(8, seed=0), 24)       # 4 pages
    sch.step()
    for s in (1, 2):
        sch.submit(_prompt(24, seed=s), 16)  # starved heads
    sch.submit(_prompt(8, seed=3), 4)        # admissible, 3rd in line
    ev = sch.step()
    assert not ev.prefill_started            # window saw only starved heads
    assert sch.run_until_idle()


# -- decode-chunk clamping ----------------------------------------------------


def test_decode_chunk_clamps_to_remaining_budget(world):
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(world["api"], world["params"], fmt="dense",
                      device="cpu")
    sch = _sched(eng, decode_chunk=8, prefill_budget=2, bucket_batch=False)
    sch.submit(_prompt(8, seed=0), 2)        # rem 1 after prefill
    sch.submit(_prompt(8, seed=1), 4)        # rem 3 after prefill
    ev = sch.step()
    # max rem 3 buckets to a 4-step chunk (not 8): waste 3 + 1
    assert ev.wasted_decode_tokens == 4
    assert sorted(c.n_new for c in ev.completed) == [2, 4]
    assert ("chunk", 4, sch.max_batch) in eng.compiled_fn_keys()
    assert ("chunk", 8, sch.max_batch) not in eng.compiled_fn_keys()
    assert sch.idle and sch.pool.used_bytes == 0
    assert sch.dispatches == {"prefill": 2, "decode_steps": 4}


def test_solo_short_request_wastes_nothing(engine):
    sch = _sched(engine, decode_chunk=8)
    sch.submit(_prompt(8, seed=0), 5)        # rem 4: one exact 4-chunk
    wasted = 0
    while not sch.idle:
        wasted += sch.step().wasted_decode_tokens
    assert wasted == 0


# -- pool lifecycle under churn -----------------------------------------------


@pytest.mark.parametrize("mode_kw", [{}, {"disaggregate": True,
                                          "prefill_chunk": 4}],
                         ids=["interleaved", "disaggregated"])
def test_pool_churn_defrag_release_leak(engine, mode_kw):
    samp = SamplingParams(temperature=0.7, seed=9)
    sch = _sched(engine, bucket_batch=False, **mode_kw)
    prompt = _prompt(10, seed=7)
    r1 = sch.submit(prompt, 4, sampling=samp, session="s0", keep=True)
    first = sch.run_until_idle()[r1]
    assert first.kept and sch.pool.used_bytes > 0
    fill = [sch.submit(_prompt(6, seed=20 + i), 3) for i in range(3)]
    assert set(sch.run_until_idle()) == set(fill)
    sch.pool.defrag()
    if sch.prefill_pool is not None:
        sch.prefill_pool.defrag()
    r2 = sch.submit(None, 6, sampling=samp, session="s0")
    second = sch.run_until_idle()[r2]
    solo = _sched(engine, bucket_batch=False)
    ref = solo.submit(prompt, 10, sampling=samp)
    want = solo.run_until_idle()[ref].tokens
    np.testing.assert_array_equal(
        np.concatenate([first.tokens, second.tokens]), want)
    assert sch.pool.used_bytes == 0
    sch.submit(_prompt(8, seed=30), 2, session="s1", keep=True)
    sch.run_until_idle()
    sch.release("s1")
    r4 = sch.submit(_prompt(8, seed=31), 2)  # admission right after release
    assert sch.run_until_idle()[r4].n_new == 2
    assert sch.pool.used_bytes == 0
    if sch.prefill_pool is not None:
        assert sch.prefill_pool.used_bytes == 0
        assert sch.shipped_bytes > 0


# -- load rows: TTFT breakdown ------------------------------------------------


def _check_mod():
    spec = importlib.util.spec_from_file_location(
        "check_serve_bench", ROOT / "benchmarks" / "check_serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_rows_ttft_breakdown_and_disagg_mode(world):
    load = loadgen.LoadConfig(duration_s=0.25, prompt_len=(4, 8),
                              output_len=(2, 6))
    rows = loadgen.bench_load_rows(
        world["api"], world["params"], None, formats=("dense",),
        rates=(32.0,), load=load, device="cpu",
        modes=("continuous", "fixed", "disaggregated"), prefill_chunk=4,
        max_batch=4, capacity=32, page_size=8, decode_chunk=2)
    assert {r["mode"] for r in rows} == {"continuous", "fixed",
                                         "disaggregated"}
    for r in rows:
        assert 0 <= r["p50_queue_wait_s"] <= r["p99_queue_wait_s"]
        assert 0 <= r["p50_prefill_s"] <= r["p99_prefill_s"]
        assert r["mean_queue_wait_s"] + r["mean_prefill_s"] == \
            pytest.approx(r["mean_ttft_s"], abs=1e-9)
        assert r["wasted_decode_tokens"] >= 0
        assert (r["shipped_bytes"] > 0) == (r["mode"] == "disaggregated")
    mod = _check_mod()
    doc = {"arch": "tiny", "batch": 4, "prompt_len": 8, "gen": 4,
           "devices": 1, "rows": rows}
    assert mod.check(doc, max_nm24_prefill_ratio=50.0) == []
    bad = dict(rows[0])
    bad["mean_queue_wait_s"] = bad["mean_ttft_s"] + 1.0
    errs = mod.check({**doc, "rows": [bad]}, max_nm24_prefill_ratio=50.0)
    assert any("breakdown does not sum" in e for e in errs)
