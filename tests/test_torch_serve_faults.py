"""Serving robustness in the port: deadlines, eviction, fault injection,
degradation — against the reference and on its own invariants.

* The same workload through the reference's scheduler and the port's
  under ``FaultPlan.chaos(seed)`` (interleaved, and disaggregated with a
  chunked window), and under deadlines, queue TTLs and page pressure with
  a kept session (evictions): equal tokens, per-step events (expiries
  included), pool bytes, counters, fired faults and shape keys.
* The invariants of the reference's ``test_serve_faults.py`` on the port:
  spill/restore, evict -> resume bitwise (greedy and seeded), idle kept
  session spills, eviction under page pressure, injected exhaustion,
  ship failures and their retries, slow steps, deadlines, cancel, shed,
  SIGTERM drain, shutdown, ``run_chaos``'s verdict, the load rows'
  robustness counters and error rows; ``PreemptionGuard`` on a real
  signal; the CLI's ``--chaos``.
"""
import importlib.util
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_serve_pair as pair  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime.fault_tolerance import PreemptionGuard  # noqa: E402
from repro_torch.serve import (GREEDY, FaultInjector, FaultPlan,  # noqa: E402
                               PagedKVCache, Rejected, SamplingParams,
                               loadgen)

ROOT = Path(__file__).resolve().parents[1]
_prompt = pair.prompt
SEEDED = SamplingParams(temperature=0.9, top_p=0.95, seed=11)


@pytest.fixture(scope="module")
def world():
    return pair.build_world()


@pytest.fixture(scope="module")
def engine(world):
    return world["engines"][pair.PORT]


def _sched(engine, **kw):
    return pair.sched(pair.PORT, engine, **kw)


def _solo(engine, prompt, n_new, samp, **kw):
    kw.setdefault("bucket_batch", False)
    sch = _sched(engine, **kw)
    rid = sch.submit(prompt, n_new, sampling=samp)
    return sch.run_until_idle()[rid].tokens


# -- against the reference scheduler -------------------------------------------


def _traffic(n, seed):
    rng = np.random.default_rng(seed)
    knobs = ({}, {"temperature": 0.9, "top_p": 0.95, "seed": 11},
             {"temperature": 1.1, "top_k": 16, "seed": 7})
    return [(_prompt(int(rng.integers(3, 14)), seed=100 * seed + i),
             int(rng.integers(8, 25)), knobs[i % 3], {}) for i in range(n)]


def _chaos(seed):
    p = FaultPlan.chaos(seed)
    return dict(exhaust_pool_at=p.exhaust_pool_at, fail_ship=p.fail_ship,
                slow_steps=p.slow_steps, sigterm_at=p.sigterm_at)


PRESSURE = [
    (_prompt(40, seed=9), 4, {}, {"session": "hog", "keep": True}),
    *[(_prompt(16, seed=s), 8, {"temperature": 0.8, "seed": s}, {})
      for s in range(3)],
    (_prompt(6, seed=7), 30, {}, {"deadline_s": 0.35}),
    (_prompt(6, seed=8), 20, {}, {"queue_ttl_s": 0.1}),
    (_prompt(5, seed=9), 6, {}, {}),
]
SCENARIOS = {
    # one arrival per step, long enough that every planned fault fires
    # (the SIGTERM lands in steps 32-47) with requests still in flight
    "chaos0": (_traffic(36, 0), dict(faults=_chaos(0), per_step=1,
                                     bucket_batch=False)),
    "chaos1-disaggregated": (_traffic(36, 1), dict(
        faults=_chaos(1), per_step=1, disaggregate=True, prefill_chunk=8)),
    "pressure-deadlines": (PRESSURE, dict(n_pages=8, max_batch=2,
                                          clock_step=0.05, per_step=1)),
}


@pytest.fixture(scope="module")
def pairs(world):
    return {name: pair.run_pair(world, reqs, **kw)
            for name, (reqs, kw) in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_reference(pairs, name):
    pair.assert_same(pairs[name])
    port = pairs[name][pair.PORT]
    if name.startswith("chaos"):
        assert {k for _, k in port["fired"]} >= {"exhaust", "sigterm",
                                                 "slow"}
        assert port["drained"]
        assert len(port["done"]) < len(SCENARIOS[name][0])
    else:
        assert port["counters"]["expired"] >= 1
        assert port["counters"]["evicted"] >= 1
        assert port["steps"][-1]["used_bytes"] == 0 or port["idle"]


def test_faultplan_chaos_matches_reference():
    for seed in range(6):
        p, q = FaultPlan.chaos(seed), JFaultPlan.chaos(seed)
        assert (p.exhaust_pool_at, p.fail_ship, p.slow_steps,
                p.sigterm_at) == (q.exhaust_pool_at, q.fail_ship,
                                  q.slow_steps, q.sigterm_at)
        assert p.describe() == q.describe()
    assert FaultPlan.chaos(7) != FaultPlan.chaos(8)
    assert FaultPlan().describe() == "no-faults"


# -- spill / restore ----------------------------------------------------------


def test_spill_restore_roundtrip_bitwise(world):
    cfg = world["cfg"]
    pool = PagedKVCache(cfg, n_pages=8, page_size=4)
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, 16, cfg.n_kv_heads, cfg.head_dim)
    k_row = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v_row = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    pool.alloc("s", 11)
    pool.store("s", k_row, v_row, 11)
    sp = pool.spill("s", capacity=16)
    assert pool.used_bytes == 0 and "s" not in pool.sessions()
    assert sp.length == 11 and sp.nbytes > 0 and sp.k.device.type == "cpu"
    assert pool.spilled_bytes_out == 3 * pool.page_bytes
    pool.restore_spill(sp)
    k, v, _, length = pool.load("s", 16)
    assert length == 11 and pool.spilled_bytes_in == 3 * pool.page_bytes
    assert torch.equal(k[:, :11], k_row[:, :11])
    assert torch.equal(v[:, :11], v_row[:, :11])
    sp2 = pool.spill("s", capacity=16)
    pool.alloc("hog", 8 * 4)
    with pytest.raises(MemoryError):
        pool.restore_spill(sp2)
    assert "s" not in pool.sessions()
    pool.free("hog")
    assert pool.used_bytes == 0


# -- eviction -> resume bitwise -----------------------------------------------


@pytest.mark.parametrize("samp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_evict_resume_mid_decode_bitwise(engine, samp):
    reqs = [(_prompt(6, seed=1), 16), (_prompt(9, seed=2), 14)]
    want = [_solo(engine, p, n, samp) for p, n in reqs]
    sch = _sched(engine, bucket_batch=False)
    rids = [sch.submit(p, n, sampling=samp) for p, n in reqs]
    for _ in range(2):
        sch.step()
    assert len(sch.slots) == 2
    assert sch._evict_row_lru()
    assert sch.counters["evicted"] == 1 and len(sch.slots) == 1
    done = sch.run_until_idle()
    assert sch.counters["evict_resumed"] == 1
    assert sch.pool.used_bytes == 0
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(done[rid].tokens, w)


def test_idle_kept_session_spill_and_resume_bitwise(engine):
    prompt = _prompt(10, seed=7)
    want = _solo(engine, prompt, 10, SEEDED)
    sch = _sched(engine, bucket_batch=False)
    r1 = sch.submit(prompt, 4, sampling=SEEDED, session="s0", keep=True)
    first = sch.run_until_idle()[r1]
    assert sch._evict_idle_lru()
    assert "s0" in sch._spilled and sch.pool.used_bytes == 0
    r2 = sch.submit(None, 6, sampling=SEEDED, session="s0")
    second = sch.run_until_idle()[r2]
    np.testing.assert_array_equal(
        np.concatenate([first.tokens, second.tokens]), want)
    assert sch.pool.used_bytes == 0


def test_page_pressure_evicts_instead_of_stalling(engine):
    sch = _sched(engine, n_pages=8)          # 64 tokens total
    sch.submit(_prompt(40, seed=9), 4, session="hog", keep=True)
    sch.run_until_idle()
    assert sch.pool.used_bytes > 0
    rids = [sch.submit(_prompt(16, seed=s), 8) for s in range(2)]
    done = sch.run_until_idle()
    assert set(rids) <= set(done)
    assert sch.counters["evicted"] >= 1
    assert "hog" in sch._spilled
    sch.release("hog")
    assert sch.pool.used_bytes == 0


# -- injected faults ----------------------------------------------------------


def test_injected_exhaustion_no_leak_bitwise(engine):
    reqs = [(_prompt(5 + s, seed=s), 6) for s in range(4)]
    want = [_solo(engine, p, n, GREEDY) for p, n in reqs]
    sch = _sched(engine, bucket_batch=False,
                 faults=FaultPlan(exhaust_pool_at=(1, 2, 3)))
    rids = [sch.submit(p, n) for p, n in reqs]
    done = sch.run_until_idle()
    assert sch._injector.fired("exhaust") >= 1
    assert sch.counters["alloc_retries"] >= 1
    assert sch.pool.used_bytes == 0
    engine.dispatch_hook = None
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(done[rid].tokens, w)


@pytest.mark.parametrize("fails,retries,failures",
                         [((1,), 1, 0), ((1, 2, 3, 4), 3, 1)],
                         ids=["transient", "persistent"])
def test_ship_failure_rolls_back_and_retries(engine, fails, retries,
                                             failures):
    """A ShipFault mutates nothing; a retry re-drives the ship, and a
    window of failures longer than the retries parks the session until
    the next step. The stream is unperturbed either way."""
    kw = dict(disaggregate=True, bucket_batch=False)
    prompt = _prompt(9, seed=3)
    want = _solo(engine, prompt, 7, SEEDED, **kw)
    sch = _sched(engine, faults=FaultPlan(fail_ship=fails), **kw)
    rid = sch.submit(prompt, 7, sampling=SEEDED)
    done = sch.run_until_idle()
    assert sch.counters["ship_retries"] == retries
    assert sch.counters["ship_failures"] == failures
    np.testing.assert_array_equal(done[rid].tokens, want)
    assert sch.pool.used_bytes == 0 and sch.prefill_pool.used_bytes == 0
    engine.dispatch_hook = None


def test_slow_step_injection_lands_in_lane_timing():
    naps = []
    inj = FaultInjector(FaultPlan(slow_steps=((2, 0.5),)), sleep=naps.append)
    inj.begin_step(1)
    inj.on_dispatch("decode")
    assert naps == []
    inj.begin_step(2)
    inj.on_dispatch("decode")
    inj.on_dispatch("decode")                # fires once per step
    assert naps == [0.5] and inj.fired("slow") == 1


def test_preemption_guard_on_a_real_signal():
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert not guard.should_save
        signal.raise_signal(signal.SIGUSR1)
        assert guard.should_save
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL


# -- deadlines / TTLs / cancel ------------------------------------------------


def test_deadline_and_ttl_expiry_free_pages(engine):
    t = [0.0]
    sch = _sched(engine, bucket_batch=False, clock=lambda: t[0], max_batch=2)
    ra = sch.submit(_prompt(6, seed=1), 30, deadline_s=5.0)
    rb = sch.submit(_prompt(6, seed=2), 30)
    rc = sch.submit(_prompt(6, seed=3), 30, queue_ttl_s=2.0)
    for _ in range(2):
        sch.step()
    assert len(sch.slots) == 2 and len(sch.queue) == 1
    t[0] = 3.0                               # past rc's TTL, not ra's deadline
    ev = sch.step()
    assert ev.expired == [rc] and len(sch.queue) == 0
    t[0] = 6.0                               # past ra's deadline
    ev = sch.step()
    assert ra in ev.expired
    assert sch.counters["expired"] == 2
    done = sch.run_until_idle()
    assert rb in done and ra not in done and rc not in done
    assert sch.pool.used_bytes == 0


def test_cancel_mid_decode_compacts_batch(engine):
    reqs = [(_prompt(6, seed=s), 16) for s in range(3)]
    want = [_solo(engine, p, n, GREEDY) for p, n in reqs]
    sch = _sched(engine, bucket_batch=False)
    rids = [sch.submit(p, n) for p, n in reqs]
    for _ in range(3):
        sch.step()
    assert len(sch.slots) == 3
    assert sch.cancel(rids[1])
    assert len(sch.slots) == 2
    assert not sch.cancel(rids[1])
    assert not sch.cancel(10_000)
    done = sch.run_until_idle()
    assert rids[1] not in done
    assert sch.counters["cancelled"] == 1
    for i in (0, 2):
        np.testing.assert_array_equal(done[rids[i]].tokens, want[i])
    assert sch.pool.used_bytes == 0


def test_cancel_queued_and_resume_requests(engine):
    sch = _sched(engine)
    sch.submit(_prompt(6, seed=1), 4, session="keep", keep=True)
    sch.run_until_idle()
    kept_bytes = sch.pool.used_bytes
    assert kept_bytes > 0
    r2 = sch.submit(_prompt(6, seed=2), 4)
    assert sch.cancel(r2) and len(sch.queue) == 0
    r3 = sch.submit(None, 4, session="keep")
    assert sch.cancel(r3)
    assert sch.pool.used_bytes == kept_bytes
    sch.release("keep")
    assert sch.pool.used_bytes == 0


# -- admission control / shed / drain -----------------------------------------


def test_shed_mode_returns_typed_rejected(engine):
    sch = _sched(engine, admission="shed", max_queue=1)
    x = sch.submit(_prompt(4, seed=1), 2)
    y = sch.submit(_prompt(4, seed=2), 2)
    assert isinstance(x, int)
    assert isinstance(y, Rejected) and y.reason == "queue_full"
    assert sch.counters["shed"] == 1
    assert sorted(sch.run_until_idle()) == [x]
    strict = _sched(engine, max_queue=1)
    strict.submit(_prompt(4), 2)
    with pytest.raises(RuntimeError, match="admission refused"):
        strict.submit(_prompt(4), 2)
    strict.run_until_idle()
    with pytest.raises(ValueError):
        _sched(engine, admission="maybe")


def test_sigterm_drains_inflight_and_shuts_down_clean(engine):
    sch = _sched(engine, bucket_batch=False, max_batch=2,
                 faults=FaultPlan(sigterm_at=2))
    rids = [sch.submit(_prompt(6, seed=s), 8) for s in range(4)]
    done = sch.run_until_idle()
    assert sch.draining and sch.drained
    assert sch._injector.fired("sigterm") == 1
    assert 0 < len(done) < len(rids)
    assert len(sch.queue) == len(rids) - len(done)
    with pytest.raises(RuntimeError, match="draining"):
        sch.submit(_prompt(4), 2)
    assert sch.shutdown() == {}
    assert sch.pool.used_bytes == 0
    engine.dispatch_hook = None
    shed = _sched(engine, admission="shed", faults=FaultPlan(sigterm_at=1))
    shed.step()
    r = shed.submit(_prompt(4), 2)
    assert isinstance(r, Rejected) and r.reason == "draining"
    engine.dispatch_hook = None


def test_shutdown_refuses_with_inflight_and_spills_kept(engine):
    sch = _sched(engine)
    sch.submit(_prompt(6, seed=1), 6, session="k", keep=True)
    sch.step()
    with pytest.raises(RuntimeError, match="in flight"):
        sch.shutdown()
    sch.run_until_idle()
    assert sch.pool.used_bytes > 0
    spills = sch.shutdown()
    assert set(spills) == {"k"} and sch.pool.used_bytes == 0


# -- the chaos harness and load rows ------------------------------------------

_CHAOS_KW = dict(max_batch=4, capacity=64, page_size=8, decode_chunk=4)


def test_run_chaos_verdict_ok(engine):
    load = loadgen.LoadConfig(arrival_rate=40.0, duration_s=0.3,
                              prompt_len=(4, 8), output_len=(2, 6))
    workload = loadgen.make_workload(load)
    assert len(workload) >= 6
    res = loadgen.run_chaos(engine, workload,
                            FaultPlan(exhaust_pool_at=(2, 4)), **_CHAOS_KW)
    assert res["ok"], res
    assert res["leaked_bytes"] == 0 and res["leaked_bytes_clean"] == 0
    assert res["stream_mismatches"] == 0
    assert res["completed_faulted"] == len(workload)
    assert any(k == "exhaust" for _, k in res["faults_fired"])
    assert engine.dispatch_hook is None


def test_run_chaos_with_sigterm_partial_completion(engine):
    load = loadgen.LoadConfig(arrival_rate=40.0, duration_s=0.4,
                              prompt_len=(4, 8), output_len=(4, 8), seed=3)
    res = loadgen.run_chaos(engine, loadgen.make_workload(load),
                            FaultPlan(sigterm_at=3), **_CHAOS_KW)
    assert res["ok"] and res["leaked_bytes"] == 0
    assert res["stream_mismatches"] == 0
    assert res["completed_faulted"] < res["completed_clean"]
    assert any(k == "sigterm" for _, k in res["faults_fired"])


def _check_mod():
    spec = importlib.util.spec_from_file_location(
        "check_serve_bench", ROOT / "benchmarks" / "check_serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_rows_carry_counters_and_error_rows(world, monkeypatch):
    load = loadgen.LoadConfig(duration_s=0.2, prompt_len=(4, 8),
                              output_len=(2, 4))
    kw = dict(formats=("dense",), rates=(32.0,), load=load, device="cpu",
              max_batch=4, capacity=32, page_size=8, decode_chunk=2)
    rows = loadgen.bench_load_rows(world["api"], world["params"], None, **kw)
    for r in rows:
        for k in ("shed", "expired", "cancelled", "evicted"):
            assert r[k] == 0
    mod = _check_mod()
    doc = {"arch": "tiny", "batch": 4, "prompt_len": 8, "gen": 4,
           "devices": 1, "rows": rows}
    assert mod.check(doc, max_nm24_prefill_ratio=50.0) == []

    def boom(*a, **k):
        raise RuntimeError("injected bench failure")

    monkeypatch.setattr(loadgen, "run_fixed", boom)
    rows = loadgen.bench_load_rows(world["api"], world["params"], None, **kw)
    by_mode = {r["mode"]: r for r in rows}
    assert "error" not in by_mode["continuous"]
    assert by_mode["fixed"]["error"] == "RuntimeError: injected bench failure"
    warnings = []
    assert mod.check({**doc, "rows": rows}, max_nm24_prefill_ratio=50.0,
                     warnings=warnings) == []
    assert len(warnings) == 1


def test_run_continuous_deadline_expires_on_virtual_clock(engine):
    load = loadgen.LoadConfig(arrival_rate=64.0, duration_s=0.25,
                              prompt_len=(4, 8), output_len=(4, 8))
    workload = loadgen.make_workload(load)
    row = loadgen.run_continuous(engine, workload, warmup=False,
                                 deadline_s=1e-6, max_batch=4, capacity=32,
                                 page_size=8, decode_chunk=2)
    assert row["expired"] > 0
    assert row["completed"] + row["expired"] >= len(workload)


def test_cli_chaos(capsys):
    tserve.main(["--arch", "llama31-8b", "--tiny", "--device", "cpu",
                 "--gen", "4", "--chaos", "--chaos-seed", "0",
                 "--load-rates", "64", "--load-duration", "0.5"])
    text = capsys.readouterr().out
    assert "chaos verdict: OK" in text
