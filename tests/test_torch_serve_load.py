"""Continuous-batching serving in the port: paged KV cache, scheduler,
load generator — against the reference and on its own invariants.

* The same workload through the reference's ``ContinuousScheduler`` and
  the port's (tiny llama31-8b, fp32, the reference's params): equal
  tokens, per-step events, pool bytes, counters and shape keys, in the
  throughput mode (pow2 row buckets, requests arriving two per step) and
  the pinned-width mode.
* The invariants of the reference's ``test_serve_load.py`` on the port:
  page accounting and leaks, store/load round trip, defrag, batched ==
  solo bitwise at the same width (greedy and sampled), scheduler ==
  fixed-batch ``generate``, kept-session resume, release, single-token
  requests, admission errors, the load rows' schema and the workload
  trace (equal to the reference's for the same config).
* ``decode_chunk`` reads nothing back to the host; the CLI's
  ``--sample`` and ``--load-bench``. Meshes are not ported (A5).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_serve_pair as pair  # noqa: E402
from repro.serve import loadgen as jloadgen  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import (GREEDY, ContinuousScheduler,  # noqa: E402
                               PagedKVCache, SamplingParams, ServeEngine,
                               loadgen, sampling)

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


def _solo(engine, prompt, n_new, samp, **kw):
    sch = _sched(engine, bucket_batch=False, **kw)
    rid = sch.submit(prompt, n_new, sampling=samp)
    return sch.run_until_idle()[rid].tokens


# -- against the reference scheduler -------------------------------------------

MIXED = [
    (_prompt(7, seed=1), 6, {}, {}),
    (_prompt(12, seed=2), 9, {"temperature": 0.8, "seed": 4}, {}),
    (_prompt(5, seed=3), 3, {"temperature": 1.2, "top_p": 0.9, "top_k": 32,
                             "seed": 5}, {}),
    (_prompt(9, seed=4), 7, {}, {}),
    (_prompt(20, seed=5), 1, {}, {}),
    (_prompt(3, seed=6), 10, {"temperature": 0.7, "seed": 2**31 + 3}, {}),
    (_prompt(16, seed=7), 12, {}, {}),
]
SCENARIOS = {
    "throughput": dict(per_step=2, bucket_batch=True),
    "pinned": dict(per_step=0, bucket_batch=False, prefill_budget=4),
}


@pytest.fixture(scope="module")
def pairs(world):
    return {name: pair.run_pair(world, MIXED, **kw)
            for name, kw in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_reference(pairs, name):
    pair.assert_same(pairs[name])
    assert set(pairs[name][pair.PORT]["done"]) == set(range(len(MIXED)))


# -- paged KV cache -----------------------------------------------------------


def test_paged_cache_accounting_and_leaks(world):
    pool = PagedKVCache(world["cfg"], n_pages=8, page_size=4)
    assert pool.used_bytes == 0 and pool.free_pages == 8
    assert pool.capacity_bytes == 8 * pool.page_bytes
    pool.alloc("a", 9)                      # 3 pages
    pool.alloc("b", 4)                      # 1 page
    assert pool.used_bytes == 4 * pool.page_bytes
    assert pool.can_admit(16) and not pool.can_admit(17)
    with pytest.raises(ValueError, match="already allocated"):
        pool.alloc("a", 1)
    with pytest.raises(MemoryError, match="exhausted"):
        pool.alloc("c", 17)
    assert "c" not in pool.sessions()        # failed alloc rolled back
    pool.extend("b", 8)                      # grow to 2 pages
    assert pool.used_bytes == 5 * pool.page_bytes
    pool.free("a")
    pool.free("b")
    assert pool.used_bytes == 0 and pool.free_pages == 8


def _rows(cfg, seed, n=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n, cfg.n_kv_heads, cfg.head_dim)
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
            torch.from_numpy(rng.normal(size=shape).astype(np.float32)))


def test_paged_cache_store_load_roundtrip(world):
    cfg = world["cfg"]
    pool = PagedKVCache(cfg, n_pages=16, page_size=4)
    k_row, v_row = _rows(cfg, 1)
    pool.alloc("s", 11)
    pool.store("s", k_row, v_row, 11)
    k, v, pos, length = pool.load("s", 32)   # wider slot than stored row
    assert length == 11 and k.shape == (cfg.n_layers, 32, cfg.n_kv_heads,
                                        cfg.head_dim)
    assert pos.tolist() == [i if i < 11 else -1 for i in range(32)]
    assert torch.equal(k[:, :11], k_row[:, :11])
    assert torch.equal(v[:, :11], v_row[:, :11])
    with pytest.raises(ValueError, match="not divisible"):
        pool.load("s", 30)
    with pytest.raises(ValueError, match="slot"):
        pool.load("s", 8)                    # 11 tokens don't fit 2 pages


def test_paged_cache_defrag_preserves_sessions(world):
    cfg = world["cfg"]
    pool = PagedKVCache(cfg, n_pages=12, page_size=4)
    rows = {}
    for i, (sid, n) in enumerate((("a", 8), ("b", 12), ("c", 7))):
        k, v = _rows(cfg, 10 + i)
        pool.alloc(sid, n)
        pool.store(sid, k, v, n)
        rows[sid] = (k, v, n)
    pool.free("b")                           # punch a hole mid-pool
    assert pool.defrag() > 0
    live = [p for s in pool.sessions() for p in pool.page_table(s)]
    assert sorted(live) == list(range(len(live)))   # compact at the front
    for sid in ("a", "c"):
        k, v, n = rows[sid]
        got_k, got_v, _, length = pool.load(sid, 16)
        assert length == n
        assert torch.equal(got_k[:, :n], k[:, :n])
        assert torch.equal(got_v[:, :n], v[:, :n])
    assert pool.defrag() == 0                # already compact: no-op


def test_meshes_are_not_ported(world, engine):
    with pytest.raises(NotImplementedError, match="A5"):
        PagedKVCache(world["cfg"], n_pages=4, page_size=4, mesh=object())
    with pytest.raises(NotImplementedError, match="A5"):
        ContinuousScheduler(engine, prefill_mesh=object())


# -- engine: shapes and host reads --------------------------------------------


def test_prefill_session_shape_shared_within_bucket(world):
    eng = ServeEngine(world["api"], world["params"], fmt="dense",
                      device="cpu")
    samp = sampling.params_arrays([GREEDY])
    for S in (5, 6, 8):                      # all pad to the 8-bucket
        padded = np.zeros((1, 8), np.int64)
        padded[0, :S] = _prompt(S, seed=S)
        tok0, k, v = eng.prefill_session(torch.from_numpy(padded), S, samp)
        assert tok0.shape == (1,) and k.shape[1] == 8
    assert eng.compiled_fn_keys() == [("prefill_session", 8)]


def test_decode_chunk_reads_nothing_back(world, engine, monkeypatch):
    """The decode chunk's loop never copies a device value to the host:
    every tensor -> Python conversion raises while it runs."""
    sch = _sched(engine, bucket_batch=False)
    sch.submit(_prompt(6, seed=1), 3, sampling=SamplingParams(
        temperature=0.9, top_k=5, seed=1))
    sch.submit(_prompt(9, seed=2), 3)
    ev = pair.PORT.StepEvents([], {}, [], 0, 0)
    sch._prefill_one(ev)
    sch._prefill_one(ev)
    sch._join_ready(ev)
    assert len(sch.slots) == 2
    active = torch.arange(sch.max_batch) < len(sch.slots)
    samp = sch._samp_tensors(len(sch.slots))

    def host_read(*a, **k):
        raise AssertionError("host read inside decode_chunk")

    for name in ("item", "tolist", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    toks, _ = engine.decode_chunk(sch._toks, sch.cache, active, samp,
                                  n_steps=4, bucket=4)
    monkeypatch.undo()
    assert toks.shape == (4, 4)


# -- scheduler: correctness ---------------------------------------------------

REQS = [
    (_prompt(7, seed=1), 6, GREEDY),
    (_prompt(12, seed=2), 9, SamplingParams(temperature=0.8, seed=4)),
    (_prompt(5, seed=3), 3, SamplingParams(temperature=1.2, top_p=0.9,
                                           top_k=32, seed=5)),
    (_prompt(9, seed=4), 7, GREEDY),
]


def test_batched_continuous_equals_solo_bitwise(engine):
    """Four concurrent requests (mixed lengths, greedy and sampled) give
    the exact tokens each gets alone at the same batch width."""
    sch = _sched(engine, bucket_batch=False)
    rids = [sch.submit(p, n, sampling=s) for p, n, s in REQS]
    done = sch.run_until_idle()
    assert sch.pool.used_bytes == 0
    for rid, (p, n, s) in zip(rids, REQS):
        assert done[rid].n_new == n
        np.testing.assert_array_equal(done[rid].tokens, _solo(engine, p, n, s),
                                      err_msg=f"request {rid}")


def test_scheduler_matches_fixed_batch_generate(engine):
    """Greedy tokens through the scheduler (B = 1 prefill, decode at the
    working width) == the fixed-batch ``generate`` (B = 4 prefill) on
    equal-length prompts: equal tokens, not equal sums (other shapes)."""
    prompts = [_prompt(8, seed=s) for s in range(4)]
    want = engine.generate({"tokens": torch.from_numpy(
        np.stack(prompts).astype(np.int64))}, 6).tokens.numpy()
    for bucket_batch in (False, True):
        sch = _sched(engine, bucket_batch=bucket_batch, prefill_budget=4)
        rids = [sch.submit(p, 6) for p in prompts]
        done = sch.run_until_idle()
        got = np.stack([done[r].tokens for r in rids])
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"bucket_batch={bucket_batch}")
    assert ("chunk", 4, 4) in engine.compiled_fn_keys()


def test_session_keep_resume_equals_oneshot(engine):
    prompt = _prompt(10, seed=7)
    samp = SamplingParams(temperature=0.8, top_p=0.9, seed=3)
    want = _solo(engine, prompt, 10, samp)
    sch = _sched(engine, bucket_batch=False)
    r1 = sch.submit(prompt, 4, sampling=samp, session="s0", keep=True)
    first = sch.run_until_idle()[r1]
    assert first.kept and sch.pool.used_bytes > 0
    r2 = sch.submit(None, 6, sampling=samp, session="s0")
    second = sch.run_until_idle()[r2]
    np.testing.assert_array_equal(
        np.concatenate([first.tokens, second.tokens]), want)
    assert sch.pool.used_bytes == 0
    with pytest.raises(KeyError, match="s0"):
        sch.submit(None, 2, session="s0")


def test_release_frees_kept_session(engine):
    sch = _sched(engine)
    sch.submit(_prompt(6), 3, session="keepme", keep=True)
    sch.run_until_idle()
    assert sch.pool.used_bytes > 0
    sch.release("keepme")
    assert sch.pool.used_bytes == 0
    with pytest.raises(KeyError):
        sch.release("keepme")


def test_single_token_request_and_page_wait(engine):
    sch = _sched(engine, n_pages=6)          # 48 tokens: ~2 requests at once
    rids = [sch.submit(_prompt(8, seed=s), 1 if s == 0 else 8)
            for s in range(5)]
    done = sch.run_until_idle()
    assert set(done) == set(rids)
    assert done[rids[0]].n_new == 1
    assert sch.pool.used_bytes == 0


def test_admission_control_and_errors(engine):
    sch = _sched(engine, max_queue=2)
    sch.submit(_prompt(4), 2)
    sch.submit(_prompt(4), 2)
    with pytest.raises(RuntimeError, match="admission refused"):
        sch.submit(_prompt(4), 2)
    sch.run_until_idle()
    with pytest.raises(ValueError, match="capacity"):
        sch.submit(_prompt(60), 8)           # 68 > capacity 64
    with pytest.raises(ValueError, match="max_new"):
        sch.submit(_prompt(4), 0)
    with pytest.raises(ValueError, match="empty prompt"):
        sch.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(KeyError, match="unknown"):
        sch.submit(None, 2, session="nope")
    with pytest.raises(ValueError, match="power of two"):
        ContinuousScheduler(engine, max_batch=3)
    with pytest.raises(ValueError, match="divisible"):
        ContinuousScheduler(engine, capacity=60, page_size=8)


# -- load generator + bench schema --------------------------------------------


def _check_mod():
    spec = importlib.util.spec_from_file_location(
        "check_serve_bench", ROOT / "benchmarks" / "check_serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_rows_schema_and_invariants(world):
    load = loadgen.LoadConfig(duration_s=0.25, prompt_len=(4, 8),
                              output_len=(2, 6))
    rows = loadgen.bench_load_rows(
        world["api"], world["params"], None, formats=("dense",),
        rates=(32.0,), load=load, device="cpu", max_batch=4, capacity=32,
        page_size=8, decode_chunk=2)
    assert {r["mode"] for r in rows} == {"continuous", "fixed"}
    for r in rows:
        assert r["completed"] == r["n_requests"] > 0
        assert r["goodput_tok_s"] <= r["offered_tok_s"] * (1 + 1e-9)
        assert 0 <= r["p50_ttft_s"] <= r["p99_ttft_s"]
        assert r["kernel_used"] == "dense" and r["kernel"] == "dense"
    mod = _check_mod()
    doc = {"arch": "tiny", "batch": 4, "prompt_len": 8, "gen": 4,
           "devices": 1, "rows": rows}
    assert mod.check(doc, max_nm24_prefill_ratio=50.0) == []
    doc["rows"] = [{"variant": "dense", "phase": "decode"}] + rows[:1]
    loadgen.merge_load_rows(doc, rows)
    assert doc["rows"][0]["phase"] == "decode" and len(doc["rows"]) == \
        1 + len(rows)
    bad = dict(rows[0])
    bad["goodput_tok_s"] = bad["offered_tok_s"] * 2
    errs = mod.check({**doc, "rows": [bad]}, max_nm24_prefill_ratio=50.0)
    assert any("exceeds offered" in e for e in errs)


def test_make_workload_matches_reference():
    for cfg in (loadgen.LoadConfig(arrival_rate=20.0, duration_s=1.0, seed=5),
                loadgen.LoadConfig(arrival_rate=7.0, duration_s=2.0, seed=1,
                                   prompt_len=(32, 512),
                                   output_len=(16, 128), vocab_size=1000)):
        a = loadgen.make_workload(cfg)
        b = jloadgen.make_workload(jloadgen.LoadConfig(
            arrival_rate=cfg.arrival_rate, duration_s=cfg.duration_s,
            seed=cfg.seed, prompt_len=cfg.prompt_len,
            output_len=cfg.output_len, vocab_size=cfg.vocab_size))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.arrival == y.arrival and x.max_new == y.max_new
            np.testing.assert_array_equal(x.prompt, y.prompt)
        arr = [r.arrival for r in a]
        assert arr == sorted(arr) and arr[-1] < cfg.duration_s
        for r in a:
            assert cfg.prompt_len[0] <= len(r.prompt) <= cfg.prompt_len[1]
            assert cfg.output_len[0] <= r.max_new <= cfg.output_len[1]


def test_cli_sample_and_load_bench(tmp_path, capsys):
    bench_file = ROOT / "BENCH_serve.json"
    before = bench_file.read_bytes()
    out = tmp_path / "b.json"
    tserve.main(["--arch", "llama31-8b", "--tiny", "--device", "cpu",
                 "--sample", "0.8,0.95,40", "--gen", "5", "--load-bench",
                 "--load-rates", "32", "--load-duration", "0.2",
                 "--load-prompt-len", "4:8", "--load-output-len", "2:6",
                 "--bench-out", str(out)])
    text = capsys.readouterr().out
    assert "served 4 requests" in text and "continuous" in text
    rows = json.loads(out.read_text())["rows"]
    assert {(r["phase"], r["mode"]) for r in rows} == \
        {("load", "continuous"), ("load", "fixed")}
    assert bench_file.read_bytes() == before      # never the committed file
