"""The port's scenario-serving engine against the JAX package's (the twin
of ``tests/test_serve.py``, plus parity with the reference).

Every test of the reference's battery runs here against the port, on the
CPU (the engine's ``device="cpu"``: trace, hetero and tune windows count
their schedules with K4's plain version): served results bit-identical to
serial evaluation, coalescing, robustness, the concurrency hammers of the
trace LRU and counters, and the disk cache's store races.  The parity test
holds served results to the reference's serial results for the pool of
``benchmarks/serve.py``; another holds the kernels' launch counts exact
under 16 threads.
"""

import importlib.util
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Scenario as JScenario
from repro.api import evaluate_scenarios as j_evaluate
from repro_torch.api import (Scenario, ServeEngine, ServeError,
                             evaluate_scenarios)
from repro_torch.api.planner import coalesce_scenarios
from repro_torch.core import schedule_cache
from repro_torch.core.trace import (GraphTrace, register_trace_dataset,
                                    reset_trace_stats, resolve_trace_dataset,
                                    trace_cache_info)
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr

TRACE_PARAMS = {"n_nodes": 1500.0, "n_edges": 6000.0, "seed": 3.0}
TYPED_PARAMS = {"n_nodes": 1200.0, "n_edges": 5000.0, "seed": 2.0}


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    """Unit tests never touch a user's on-disk cache by default."""
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")


def engine(**kw) -> ServeEngine:
    return ServeEngine(device="cpu", **kw)


def serial(scenarios):
    return evaluate_scenarios(scenarios, device="cpu").results


def _pool():
    return [
        Scenario.tile("engn", K=1024.0, label="tile-a"),
        Scenario.tile("hygcn", K=512.0, label="tile-b"),
        Scenario.full_graph("engn", V=2708.0, E=10556.0, N=1433.0, T=7.0,
                            widths=(1433.0, 16.0, 7.0), tile_vertices=512.0,
                            label="full-a"),
        Scenario.trace("engn", dataset="power_law", params=TRACE_PARAMS,
                       N=32.0, T=8.0, tile_vertices=256.0, label="trace-a"),
        Scenario.trace("engn", dataset="power_law", params=TRACE_PARAMS,
                       N=32.0, T=8.0, tile_vertices=512.0, label="trace-b"),
        Scenario.hetero("engn", dataset="typed_power_law", n_relations=3,
                        params=TYPED_PARAMS, N=[30.0, 20.0, 10.0], T=5.0,
                        tile_vertices=256.0, label="hetero-a"),
        Scenario.minibatch("hygcn", dataset="power_law", params=TRACE_PARAMS,
                           batch_nodes=32, fanout=(4, 4), n_batches=3,
                           N=32.0, T=8.0, label="minibatch-a"),
        Scenario.trace("engn", dataset="power_law", params=TRACE_PARAMS,
                       N=16.0, T=4.0, tile_vertices=256.0,
                       optimize={"objective": "movement",
                                 "space": {"tile_vertices": [128.0, 256.0]}},
                       label="tune-a"),
    ]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(results):
    return [(r.total_bits, r.total_iterations, r.offchip_bits,
             r.cache_bits, r.onchip_bits, dict(r.breakdown),
             dict(r.iteration_breakdown), r.n_tiles) for r in results]


# ---------------------------------------------------------------------------
# coalesce_scenarios
# ---------------------------------------------------------------------------
def test_coalesce_scenarios_dedup_and_backmap():
    pool = _pool()
    flat = [pool[0], pool[1], pool[0], pool[3], pool[1], pool[0]]
    distinct, backmap = coalesce_scenarios(flat)
    assert [s.label for s in distinct] == ["tile-a", "tile-b", "trace-a"]
    assert backmap == (0, 1, 0, 2, 1, 0)
    assert [distinct[j] for j in backmap] == flat


def test_coalesce_scenarios_distinguishes_equal_plan_keys():
    a = Scenario.tile("engn", K=1024.0)
    b = Scenario.tile("engn", K=2048.0)  # same plan key, different leaf
    assert a.plan_key() == b.plan_key()
    distinct, backmap = coalesce_scenarios([a, b, a])
    assert len(distinct) == 2 and backmap == (0, 1, 0)


def test_coalesce_scenarios_rejects_non_scenarios():
    with pytest.raises(TypeError):
        coalesce_scenarios([Scenario.tile("engn"), {"dataflow": "engn"}])


# ---------------------------------------------------------------------------
# Bit-identity: served == serial, every scenario kind.
# ---------------------------------------------------------------------------
def test_run_once_bit_identical_across_kinds():
    pool = _pool()
    requests = [[pool[0], pool[3]], [pool[5]], [pool[6], pool[7]],
                [pool[2]], [pool[4], pool[0]], [pool[1]]]
    oracle = [serial(req) for req in requests]
    eng = engine()
    futures = [eng.submit_future(req) for req in requests]
    assert eng.run_once() == len(requests)
    for fut, expect in zip(futures, oracle):
        got = fut.result(timeout=0)
        assert _records(got.results) == _records(expect)
        for r in got.results:
            assert "serve" in r.meta


def test_threaded_submit_bit_identical():
    pool = _pool()
    requests = [[pool[i % len(pool)]] for i in range(24)]
    oracle = [serial(req) for req in requests]
    with engine(window_s=0.005) as eng:
        with ThreadPoolExecutor(max_workers=8) as ex:
            handles = list(ex.map(lambda r: eng.submit_future(r), requests))
        outs = [h.result(timeout=30) for h in handles]
    for got, expect in zip(outs, oracle):
        assert _records(got.results) == _records(expect)


def test_serial_result_meta_keeps_trace_provenance():
    """The scatter merges serve meta in; it must not drop planner meta."""
    s = _pool()[3]
    eng = engine()
    fut = eng.submit_future([s])
    eng.run_once()
    meta = fut.result(timeout=0).results[0].meta
    assert "trace" in meta and "serve" in meta
    assert meta["trace"]["n_nodes"] == 1500


def test_served_results_match_reference_serial_on_the_bench_pool():
    """benchmarks/serve.py's pool, duplicate-heavy requests of 1-3
    scenarios (its load generator, seed 0; chip_smoke.py's copies), served
    from 8 threads: every result equals the reference's serial result bit
    for bit."""
    smoke = _chip_smoke()
    pool = smoke.serve_pool(Scenario)
    assert len(pool) == 24
    requests = smoke.serve_requests(pool, 60, 0)
    ref = {s: j_evaluate([JScenario.from_dict(s.to_dict())]).results[0]
           for s in pool}
    with engine(window_s=0.002) as eng:
        with ThreadPoolExecutor(max_workers=8) as ex:
            handles = list(ex.map(lambda r: eng.submit_future(r), requests))
        outs = [h.result(timeout=60) for h in handles]
    for req, got in zip(requests, outs):
        assert _records(got.results) == _records([ref[s] for s in req])
    tuned = next(r for got in outs for r in got.results
                 if r.scenario.optimize is not None)
    assert tuned.meta["tune"] == ref[tuned.scenario].meta["tune"]
    assert eng.metrics()["coalesce_rate"] > 0.0


def test_chip_smoke_serve_load_is_the_benchmarks():
    """chip_smoke.py copies benchmarks/serve.py's pool and load generator
    (it may not import the reference): the copies build the same
    scenarios and the same requests."""
    from benchmarks import serve as bench
    smoke = _chip_smoke()
    assert smoke.SERVE_TRACE_PARAMS == bench.TRACE_PARAMS
    assert smoke.SERVE_TYPED_PARAMS == bench.TYPED_PARAMS
    ref_pool = bench.build_pool()
    port_pool = smoke.serve_pool(Scenario)
    assert [s.to_dict() for s in port_pool] == [
        s.to_dict() for s in ref_pool]
    ref_req = bench.build_requests(ref_pool, 50, 0)
    port_req = smoke.serve_requests(port_pool, 50, 0)
    assert [[s.to_dict() for s in r] for r in port_req] == [
        [s.to_dict() for s in r] for r in ref_req]


# ---------------------------------------------------------------------------
# Coalescing: N duplicates -> one evaluation.
# ---------------------------------------------------------------------------
def test_duplicate_requests_one_evaluation():
    s = Scenario.tile("engn", K=1024.0)
    eng = engine()
    n = 7
    futures = [eng.submit_future([s]) for _ in range(n)]
    eng.run_once()
    m = eng.metrics()
    assert m["requests"] == n and m["scenarios"] == n
    assert m["distinct_scenarios"] == 1
    assert m["evaluations"] == 1
    assert m["coalesce_rate"] == pytest.approx(1 - 1 / n)
    for fut in futures:
        serve = fut.result(timeout=0).serve
        assert serve["n_requests"] == n
        assert serve["n_evaluations"] == 1
        assert serve["coalesce_rate"] == pytest.approx(1 - 1 / n)


def test_distinct_plan_keys_one_group_each():
    a = Scenario.tile("engn", K=1024.0)
    b = Scenario.tile("hygcn", K=1024.0)
    c = Scenario.tile("engn", K=2048.0)  # same group as a (stacked leaf)
    eng = engine()
    futures = [eng.submit_future([s]) for s in (a, b, c, a, b, c)]
    eng.run_once()
    m = eng.metrics()
    assert m["scenarios"] == 6
    assert m["distinct_scenarios"] == 3
    assert m["evaluations"] == 2  # {a, c} broadcast together; b alone
    for fut in futures:
        fut.result(timeout=0)


def test_duplicate_tune_requests_one_tuner_run():
    tune = _pool()[7]
    reset_trace_stats()
    eng = engine()
    futures = [eng.submit_future([tune]) for _ in range(5)]
    eng.run_once()
    assert eng.metrics()["evaluations"] == 1  # one tuner run, not five
    recs = [_records(f.result(timeout=0).results) for f in futures]
    assert all(r == recs[0] for r in recs)


def test_windows_share_warm_caches():
    """A second window over the same trace reuses schedules."""
    s = _pool()[3]
    eng = engine()
    eng.submit_future([s])
    eng.run_once()
    eng.submit_future([s])
    eng.run_once()
    f = eng.submit_future([s])
    eng.run_once()
    cache = f.result(timeout=0).serve["cache"]
    assert cache["trace_builds"] == 0
    assert cache["schedule_computes"] == 0
    assert cache["schedule_cache_hits"] >= 1


# ---------------------------------------------------------------------------
# Metrics schema.
# ---------------------------------------------------------------------------
def test_serve_meta_schema():
    eng = engine()
    fut = eng.submit_future([Scenario.tile("engn")])
    eng.run_once()
    got = fut.result(timeout=0)
    serve = got.serve
    for key in ("window", "fallback", "n_requests", "n_scenarios",
                "n_distinct_scenarios", "n_evaluations", "coalesce_rate",
                "eval_s", "cache"):
        assert key in serve
    for key in ("trace_builds", "factorizations", "schedule_computes",
                "schedule_cache_hits", "schedule_disk_hits",
                "schedule_hit_rate", "disk_graph_hits",
                "disk_schedule_hits"):
        assert key in serve["cache"]
    per_result = got.results[0].meta["serve"]
    assert per_result["request_scenarios"] == 1
    assert per_result["latency_s"] >= 0.0
    assert "serve" in got.results[0].to_dict()
    d = got.to_dict()
    assert d["serve"]["n_requests"] == 1 and len(d["results"]) == 1


def test_engine_metrics_schema():
    eng = engine()
    m = eng.metrics()
    for key in ("windows", "requests", "scenarios", "distinct_scenarios",
                "evaluations", "rejected_requests", "failed_requests",
                "fallback_windows", "coalesce_rate"):
        assert key in m
    assert m["windows"] == 0 and m["coalesce_rate"] == 0.0


# ---------------------------------------------------------------------------
# Robustness: malformed requests, evaluation failures, lifecycle.
# ---------------------------------------------------------------------------
def test_malformed_requests_rejected_at_submit():
    eng = engine()
    for bad in (42, "scenario", [], [42], [{"graph": {}}],
                [{"dataflow": "engn", "graph": {"K": "not-a-number"}}]):
        with pytest.raises(ServeError):
            eng.submit_future(bad)
    assert eng.metrics()["rejected_requests"] == 6
    fut = eng.submit_future([Scenario.tile("engn")])
    eng.run_once()
    assert fut.result(timeout=0).results[0].total_bits > 0


def test_evaluation_failure_isolated_to_offending_request():
    good = Scenario.tile("engn", K=1024.0)
    bad = Scenario.tile("no_such_dataflow", K=1024.0)  # fails at registry.get
    eng = engine()
    f_good = eng.submit_future([good])
    f_bad = eng.submit_future([bad])
    f_good2 = eng.submit_future([good])
    eng.run_once()
    with pytest.raises(KeyError):
        f_bad.result(timeout=0)
    oracle = serial([good])
    assert _records(f_good.result(timeout=0).results) == _records(oracle)
    assert f_good.result(timeout=0).serve["fallback"] is True
    assert _records(f_good2.result(timeout=0).results) == _records(oracle)
    m = eng.metrics()
    assert m["failed_requests"] == 1 and m["fallback_windows"] == 1
    f3 = eng.submit_future([good])
    eng.run_once()
    assert f3.result(timeout=0).serve["fallback"] is False


def test_stop_drains_queue():
    s = Scenario.tile("engn")
    eng = engine(window_s=0.001)
    eng.start()
    futures = [eng.submit_future([s]) for _ in range(10)]
    eng.stop()
    for fut in futures:
        assert fut.result(timeout=0).results[0].total_bits > 0


def test_empty_and_oversize_windows():
    eng = engine(max_window_scenarios=2)
    assert eng.run_once() == 0  # an empty queue is a no-op
    s = Scenario.tile("engn")
    futures = [eng.submit_future([s, s]) for _ in range(3)]
    assert eng.run_once() == 1
    assert eng.run_once() == 1
    assert eng.run_once() == 1
    for fut in futures:
        fut.result(timeout=0)
    with pytest.raises(ValueError):
        ServeEngine(window_s=-1.0)
    with pytest.raises(ValueError):
        ServeEngine(max_window_scenarios=0)


def test_double_start_rejected():
    eng = engine()
    eng.start()
    try:
        with pytest.raises(RuntimeError):
            eng.start()
    finally:
        eng.stop()


def test_trace_window_without_a_card_fails_its_requests(monkeypatch):
    """The engine's default device is the card: without one, a trace
    request fails (the window falls back, the request raises) instead of
    running on the CPU, and a tile request beside it still serves."""
    from repro_torch.core.trace import clear_trace_cache
    clear_trace_cache()  # no schedule of an earlier test may answer it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = ServeEngine()
    f_trace = eng.submit_future([_pool()[3]])
    f_tile = eng.submit_future([Scenario.tile("engn")])
    eng.run_once()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f_trace.result(timeout=0)
    assert f_tile.result(timeout=0).serve["fallback"] is True


# ---------------------------------------------------------------------------
# Concurrency: the trace LRU, the counters and the launch counts.
# ---------------------------------------------------------------------------
def test_concurrent_resolve_single_flight(monkeypatch):
    """8 threads resolving one cold dataset -> exactly one build."""
    from repro_torch.core import trace as trace_mod
    name = "serve_test_single_flight"
    # Registered for this test only: the registry is process-wide.
    monkeypatch.setitem(trace_mod._TRACE_DATASETS, name, None)
    calls = {"n": 0}

    def builder(*, seed=0):
        calls["n"] += 1
        rng = np.random.default_rng(int(seed))
        return GraphTrace(rng.integers(0, 200, 2000),
                          rng.integers(0, 200, 2000), 200)

    register_trace_dataset(name, builder, overwrite=True)
    reset_trace_stats()
    barrier = threading.Barrier(8)
    got = []

    def resolve():
        barrier.wait()
        got.append(resolve_trace_dataset(name, {"seed": 7}))

    threads = [threading.Thread(target=resolve) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert calls["n"] == 1
    assert trace_cache_info()["stats"]["trace_builds"] == 1
    assert all(g is got[0] for g in got)


def test_concurrent_stat_bumps_exact():
    from repro_torch.core.trace import _bump_stat

    reset_trace_stats()
    n_threads, n_iter = 8, 2000

    def hammer():
        for _ in range(n_iter):
            _bump_stat("schedule_cache_hits")

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert trace_cache_info()["stats"]["schedule_cache_hits"] == \
        n_threads * n_iter
    reset_trace_stats()


def test_concurrent_schedule_same_capacity_one_compute():
    rng = np.random.default_rng(11)
    trace = GraphTrace(rng.integers(0, 500, 4000),
                       rng.integers(0, 500, 4000), 500)
    reset_trace_stats()
    barrier = threading.Barrier(8)
    scheds = []

    def query():
        barrier.wait()
        scheds.append(trace.schedule(64, device="cpu"))

    threads = [threading.Thread(target=query) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    stats = trace_cache_info()["stats"]
    assert stats["schedule_computes"] == 1
    assert stats["schedule_cache_hits"] == 7
    assert stats["factorizations"] == 1
    assert all(s is scheds[0] for s in scheds)


def test_concurrent_schedule_lru_hammer():
    """Mixed capacities from many threads: the LRU's order and counts stay
    coherent."""
    rng = np.random.default_rng(13)
    trace = GraphTrace(rng.integers(0, 400, 3000),
                       rng.integers(0, 400, 3000), 400)
    caps = [16, 32, 64, 128, 256, 400]
    reset_trace_stats()
    errors = []

    def hammer(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(200):
                cap = caps[int(r.integers(0, len(caps)))]
                sched = trace.schedule(cap, device="cpu")
                assert int(sched.vertex_counts.sum()) == 400
        except Exception as exc:  # pragma: no cover - the regression
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert trace_cache_info()["stats"]["schedule_computes"] <= len(caps)
    for cap in caps:
        np.testing.assert_array_equal(
            trace.schedule(cap, device="cpu").vertex_counts,
            trace.schedule_reference(cap).vertex_counts)


def test_concurrent_typed_relation_carving():
    from repro_torch.core.trace import TypedGraphTrace

    rng = np.random.default_rng(17)
    trace = TypedGraphTrace(rng.integers(0, 300, 2500),
                            rng.integers(0, 300, 2500),
                            rng.integers(0, 4, 2500), 300, 4)
    reset_trace_stats()
    results = []

    def carve():
        results.append(tuple(trace.relation(r).n_edges for r in range(4)))

    threads = [threading.Thread(target=carve) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert trace_cache_info()["stats"]["factorizations"] == 1
    assert len(set(results)) == 1
    assert sum(results[0]) == 2500


def test_launch_counts_exact_under_16_threads():
    """16 threads each call K4's counted wrapper on the CPU (its plain
    route, which launches nothing and counts nothing) and add launches
    through the wrapper's counter, with a short switch interval to provoke
    lost updates: every count is exact and every result the plain
    version's."""
    rng = np.random.default_rng(5)
    trace = GraphTrace(rng.integers(0, 300, 2000),
                       rng.integers(0, 300, 2000), 300)
    u_snd, u_rcv, u_new_src, mp = trace._pair_factorization()
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a))
                    for a in (u_snd, u_rcv, u_new_src, np.diff(mp)))
    n_tiles, K = trace._geometry(32)
    expect = sr.schedule_counts_plain(*tensors, K, n_tiles)
    k4 = "segment_reduce.schedule_counts"
    n_threads, n_iter = 16, 300
    barrier = threading.Barrier(n_threads)
    wrong = []

    def hammer():
        barrier.wait()
        for _ in range(n_iter):
            got = ops.schedule_counts(*tensors, K, n_tiles)
            if not all(torch.equal(g, e) for g, e in zip(got, expect)):
                wrong.append(got)
            ops._launched(k4)

    ops.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not wrong
    assert ops.LAUNCHES[k4] == n_threads * n_iter
    assert sum(ops.LAUNCHES.values()) == n_threads * n_iter
    ops.reset_launches()


# ---------------------------------------------------------------------------
# The disk cache: benign store races, eviction-safe stats, serve counters.
# ---------------------------------------------------------------------------
def _store_args(seed=0):
    rng = np.random.default_rng(seed)
    snd = np.sort(rng.integers(0, 50, 300))
    rcv = rng.integers(0, 50, 300)
    trace = GraphTrace(snd, rcv, 50)
    u_snd, u_rcv, _, mp = trace._pair_factorization()
    return dict(n_nodes=50, n_edges=300, row_ptr=trace.row_ptr,
                fact_u_snd=u_snd, fact_u_rcv=u_rcv, fact_mult_prefix=mp)


def test_store_graph_double_store_benign(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    schedule_cache.reset_cache_stats()
    key = schedule_cache.graph_cache_key("serve-test", "{}", "v1")
    assert schedule_cache.store_graph(key, **_store_args())
    assert schedule_cache.store_graph(key, **_store_args())  # exists branch
    stats = schedule_cache.cache_stats()
    assert stats["counters"]["store_races"] == 1
    assert stats["entries"]["graphs"] == 1
    assert schedule_cache.load_graph(key) is not None


def test_store_graph_toctou_race_benign(tmp_path, monkeypatch):
    """A writer landing the entry between the exists check and the rename
    makes the loser's store a benign no-op."""
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    schedule_cache.reset_cache_stats()
    key = schedule_cache.graph_cache_key("serve-test-race", "{}", "v1")
    real_replace = os.replace
    state = {"raced": False}

    def racing_replace(src, dst):
        if not state["raced"] and str(dst).endswith(".graph"):
            state["raced"] = True
            # the winner lands the entry first (its own rename is real)
            assert schedule_cache.store_graph(key, **_store_args())
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", racing_replace)
    assert schedule_cache.store_graph(key, **_store_args())  # the loser
    monkeypatch.setattr(os, "replace", real_replace)
    assert schedule_cache.cache_stats()["counters"]["store_races"] == 1
    assert schedule_cache.load_graph(key) is not None
    assert list(tmp_path.rglob("*.tmp")) == []


def test_store_graph_threaded_hammer(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    schedule_cache.reset_cache_stats()
    key = schedule_cache.graph_cache_key("serve-test-hammer", "{}", "v1")
    args = _store_args()
    outcomes = []
    barrier = threading.Barrier(6)

    def store():
        barrier.wait()
        outcomes.append(schedule_cache.store_graph(key, **args))

    threads = [threading.Thread(target=store) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert outcomes == [True] * 6
    assert schedule_cache.cache_stats()["entries"]["graphs"] == 1
    assert schedule_cache.load_graph(key) is not None


def test_cache_stats_schema_and_eviction_safety(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    schedule_cache.reset_cache_stats()
    stats = schedule_cache.cache_stats()
    assert stats["enabled"] and stats["root"] == str(tmp_path)
    assert stats["entries"] == {"graphs": 0, "schedules": 0}
    key = schedule_cache.graph_cache_key("serve-test-stats", "{}", "v1")
    schedule_cache.store_graph(key, **_store_args())
    skey = schedule_cache.schedule_cache_key("serve-test-stats", "{}",
                                             "v1", 16)
    schedule_cache.store_schedule(
        skey, n_tiles=4, capacity=16, K=13,
        vertex_counts=np.ones(4), edge_counts=np.ones(4),
        halo_counts=np.ones(4), remote_edge_counts=np.ones(4))
    stats = schedule_cache.cache_stats()
    assert stats["entries"] == {"graphs": 1, "schedules": 1}
    assert stats["bytes"] > 0
    assert stats["counters"]["graph_stores"] == 1
    assert stats["counters"]["schedule_stores"] == 1
    import shutil
    shutil.rmtree(tmp_path)
    stats = schedule_cache.cache_stats()
    assert stats["entries"] == {"graphs": 0, "schedules": 0}
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")
    assert schedule_cache.cache_stats()["enabled"] is False


def test_serve_window_uses_disk_cache_counters(tmp_path, monkeypatch):
    """A cold trace resolve inside a serve window shows the disk store in
    ``meta["serve"]["cache"]``; a second engine after the LRU is cleared
    loads the graph from disk and builds nothing."""
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    from repro_torch.core.trace import clear_trace_cache
    clear_trace_cache()
    params = dict(TRACE_PARAMS)
    params["seed"] = 99.0  # a key no other test resolves
    s = Scenario.trace("engn", dataset="power_law", params=params,
                       N=16.0, T=4.0, tile_vertices=256.0)
    eng = engine()
    f = eng.submit_future([s])
    eng.run_once()
    cache = f.result(timeout=0).serve["cache"]
    assert cache["trace_builds"] == 1
    assert schedule_cache.cache_stats()["counters"]["graph_stores"] >= 1
    clear_trace_cache()
    eng2 = engine()
    f2 = eng2.submit_future([s])
    eng2.run_once()
    cache2 = f2.result(timeout=0).serve["cache"]
    assert cache2["trace_builds"] == 0
    assert cache2["disk_graph_hits"] == 1
    assert cache2["schedule_disk_hits"] == 1
    assert cache2["schedule_computes"] == 0
    assert _records(f2.result(timeout=0).results) == _records(
        f.result(timeout=0).results)
    clear_trace_cache()
