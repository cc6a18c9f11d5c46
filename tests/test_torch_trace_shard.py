"""The port's sharded trace pipeline held to the reference (the twin of
``tests/test_trace_shard.py`` and of ``tests/test_hetero.py``'s sharded
typed case).

Every sharded factorization of the port must equal, bit for bit (values,
order and dtypes; ``factorization_drift`` returns ``[]``), the port's
single-host factorization of the same ``power_law_stream`` edges and the
reference's sharded factorization on the same seed, at shard counts 1, 2, 4
and 7.  Schedules from a factorization-only trace must equal the
per-capacity ``np.unique`` oracle under every port engine (``torch`` runs
K4's plain version on the CPU).  Counts are integers: tolerance 0.
"""

import numpy as np
import pytest

from repro.api import Scenario as JScenario
from repro.api import evaluate_scenario as j_evaluate_scenario
from repro.core.trace import resolve_trace_dataset as j_resolve
from repro.distributed import trace_shard as j_trace_shard
from repro_torch.api import Scenario, evaluate_scenario
from repro_torch.core.trace import (GraphTrace, TypedGraphTrace,
                                    clear_trace_cache,
                                    resolve_trace_dataset,
                                    trace_dataset_names)
from repro_torch.data import synthetic
from repro_torch.distributed import trace_shard

COUNT_FIELDS = ("vertex_counts", "edge_counts", "halo_counts",
                "remote_edge_counts")

#: The reference battery's graph: 3 generation blocks with a ragged tail.
V, E, SEED, ALPHA = 3000, 2 * synthetic.POWER_LAW_STREAM_CHUNK + 12345, 11, 1.5
SHARD_COUNTS = (1, 2, 4, 7)
TYPED_PARAMS = {"n_relations": 3, "n_nodes": 200, "n_edges": 900, "seed": 1}


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")
    yield


@pytest.fixture(scope="module")
def single_host():
    snd, rcv = synthetic.power_law_edges(SEED, n_nodes=V, n_edges=E,
                                         alpha=ALPHA)
    return GraphTrace(snd, rcv, V)


@pytest.fixture(scope="module")
def sharded_trace():
    return trace_shard.build_power_law_trace(n_nodes=V, n_edges=E,
                                             seed=SEED, alpha=ALPHA,
                                             n_shards=3)


# ---------------------------------------------------------------------------
# The generator: chunk-size and shard-count invariance.
# ---------------------------------------------------------------------------
def test_edge_stream_chunk_size_invariance():
    base = list(synthetic.power_law_edge_stream(SEED, n_nodes=V, n_edges=E,
                                                alpha=ALPHA))
    snd0 = np.concatenate([p[0] for p in base])
    rcv0 = np.concatenate([p[1] for p in base])
    assert snd0.size == E
    for chunk in (1000, 4096, 99_999, E, 10 * E):
        parts = list(synthetic.power_law_edge_stream(
            SEED, n_nodes=V, n_edges=E, alpha=ALPHA, chunk_edges=chunk))
        assert all(p[0].size == chunk for p in parts[:-1])
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in parts]), snd0)
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in parts]), rcv0)


def test_edge_stream_shard_union_is_the_single_stream():
    snd0, rcv0 = synthetic.power_law_edges(SEED, n_nodes=V, n_edges=E,
                                           alpha=ALPHA)
    n_blocks = synthetic.power_law_stream_blocks(E)
    assert n_blocks == 3
    B = synthetic.POWER_LAW_STREAM_CHUNK
    for n_shards in (1, 2, 3, 8):
        # Round-robin block ownership: the shard streams put back in block
        # order are the single-shard stream.
        got_snd = np.empty_like(snd0)
        got_rcv = np.empty_like(rcv0)
        total = 0
        for shard in range(n_shards):
            s, r = synthetic.power_law_edges(
                SEED, n_nodes=V, n_edges=E, alpha=ALPHA,
                shard=shard, n_shards=n_shards)
            at = 0
            for b in range(shard, n_blocks, n_shards):
                m = min(B, E - b * B)
                got_snd[b * B:b * B + m] = s[at:at + m]
                got_rcv[b * B:b * B + m] = r[at:at + m]
                at += m
            assert at == s.size
            total += s.size
        assert total == E
        np.testing.assert_array_equal(got_snd, snd0)
        np.testing.assert_array_equal(got_rcv, rcv0)
    with pytest.raises(ValueError, match="shard"):
        list(synthetic.power_law_edge_stream(SEED, n_nodes=V, n_edges=E,
                                             shard=2, n_shards=2))


# ---------------------------------------------------------------------------
# The sharded factorization: the port's single host and the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_factorization_bitmatches_single_host(single_host, n_shards):
    u_snd, u_rcv, _, mp = single_host._pair_factorization()
    fact = trace_shard.sharded_power_law_factorization(
        n_nodes=V, n_edges=E, seed=SEED, alpha=ALPHA, n_shards=n_shards)
    assert trace_shard.factorization_drift(fact, (u_snd, u_rcv, mp)) == []


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_factorization_bitmatches_reference(n_shards):
    """The port's sharded build equals the reference's sharded build on the
    same seed (values, order, dtypes), and so its single-host one too."""
    fact = trace_shard.sharded_power_law_factorization(
        n_nodes=V, n_edges=E, seed=SEED, alpha=ALPHA, n_shards=n_shards)
    expect = j_trace_shard.sharded_power_law_factorization(
        n_nodes=V, n_edges=E, seed=SEED, alpha=ALPHA, n_shards=n_shards)
    assert trace_shard.factorization_drift(fact, expect) == []
    j_single = j_resolve("power_law_stream", {
        "n_nodes": V, "n_edges": E, "seed": SEED, "alpha": ALPHA})
    u_snd, u_rcv, _, mp = j_single._pair_factorization()
    assert trace_shard.factorization_drift(fact, (u_snd, u_rcv, mp)) == []


def test_factorization_drift_reports_mismatches():
    a = (np.array([1, 2], np.int32), np.array([3, 4], np.int32),
         np.array([0, 1, 2], np.int64))
    assert trace_shard.factorization_drift(a, a) == []
    b = (a[0].astype(np.int64), a[1][:1], np.array([0, 1, 5], np.int64))
    errs = trace_shard.factorization_drift(a, b)
    assert errs == j_trace_shard.factorization_drift(a, b)
    assert len(errs) == 3
    assert any("dtype" in e for e in errs)
    assert any("shape" in e for e in errs)
    assert any("mismatch at index 2" in e for e in errs)


def test_sharded_build_stats_and_shard_cap():
    stats = {}
    trace = trace_shard.build_power_law_trace(
        n_nodes=V, n_edges=E, seed=SEED, alpha=ALPHA, n_shards=64,
        stats=stats)
    # Generation runs one shard per stream block at most, while the
    # exchange still buckets into the full requested shard count.
    assert stats["n_shards"] == 64
    assert stats["n_generation_shards"] == \
        synthetic.power_law_stream_blocks(E) == 3
    assert len(stats["bucket_unique"]) <= 64
    assert sum(stats["shard_edges"]) == E
    assert sum(stats["bucket_unique"]) == stats["n_unique_pairs"]
    assert trace.n_edges == E and not trace.has_edge_list
    for key in ("t_generate_sort_s", "t_exchange_factorize_s", "t_csr_s",
                "rss_generate_sort_kb", "rss_csr_kb"):
        assert key in stats
    j_stats = {}
    j_trace_shard.build_power_law_trace(
        n_nodes=V, n_edges=E, seed=SEED, alpha=ALPHA, n_shards=64,
        stats=j_stats)
    for key in ("n_shards", "n_generation_shards", "shard_edges",
                "bucket_unique", "n_unique_pairs"):
        assert stats[key] == j_stats[key], key


# ---------------------------------------------------------------------------
# Factorization-only traces: CSR, degrees, schedules, the oracle's refusal.
# ---------------------------------------------------------------------------
def test_factorized_trace_matches_edge_list_trace(single_host, sharded_trace):
    assert sharded_trace.n_edges == single_host.n_edges == E
    np.testing.assert_array_equal(sharded_trace.row_ptr,
                                  single_host.row_ptr)
    np.testing.assert_array_equal(sharded_trace.csr_senders,
                                  single_host.csr_senders)
    np.testing.assert_array_equal(sharded_trace.in_degrees(),
                                  single_host.in_degrees())
    np.testing.assert_array_equal(sharded_trace.out_degrees(),
                                  single_host.out_degrees())


@pytest.mark.parametrize("engine", ["torch", "numpy", "sharded"])
def test_factorized_trace_schedules_all_engines(single_host, sharded_trace,
                                                engine):
    caps = [97, 500, 1500, V]
    scheds = sharded_trace.schedules(caps, engine=engine, device="cpu")
    sharded_trace.clear_schedules()  # engines must not serve each other
    for cap, sched in zip(caps, scheds):
        ref = single_host.schedule_reference(cap)
        for f in COUNT_FIELDS:
            np.testing.assert_array_equal(
                getattr(sched, f), getattr(ref, f),
                err_msg=f"engine={engine} cap={cap} field={f}")
        np.testing.assert_array_equal(sched.cache_hit_fraction(0.1),
                                      ref.cache_hit_fraction(0.1))


def test_schedule_reference_refuses_factorization_only(sharded_trace):
    with pytest.raises(RuntimeError, match="materialized edge list"):
        sharded_trace.schedule_reference(500)


def test_from_factorization_validates_shapes():
    with pytest.raises(ValueError, match="mult_prefix"):
        GraphTrace.from_factorization(4, [0, 1], [1, 2], [0, 1])  # U+1 != 3
    with pytest.raises(ValueError, match="n_nodes"):
        GraphTrace.from_factorization(0, [], [], [0])
    empty = GraphTrace.from_factorization(5, [], [], [0])
    assert empty.n_edges == 0
    for engine in ("torch", "numpy", "sharded"):
        empty.clear_schedules()
        assert empty.schedule(2, engine=engine, device="cpu").halo_total == 0


def test_sharded_schedule_counts_chunking_is_invariant(single_host):
    fact = single_host._pair_factorization()
    ref_h, ref_r = trace_shard.sharded_schedule_counts(fact, 500, 6,
                                                       n_shards=1)
    for n_shards in (2, 3, 16, 10_000):
        h, r = trace_shard.sharded_schedule_counts(fact, 500, 6,
                                                   n_shards=n_shards)
        np.testing.assert_array_equal(h, ref_h)
        np.testing.assert_array_equal(r, ref_r)
    j_h, j_r = j_trace_shard.sharded_schedule_counts(fact, 500, 6,
                                                     n_shards=7)
    assert ref_h.dtype == j_h.dtype and ref_r.dtype == j_r.dtype
    np.testing.assert_array_equal(ref_h, j_h)
    np.testing.assert_array_equal(ref_r, j_r)


def test_default_shard_count_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_SHARDS", "5")
    assert trace_shard.default_shard_count() == 5
    monkeypatch.setenv("REPRO_TORCH_TRACE_SHARDS", "zero")
    with pytest.raises(ValueError, match="REPRO_TORCH_TRACE_SHARDS"):
        trace_shard.default_shard_count()
    monkeypatch.setenv("REPRO_TORCH_TRACE_SHARDS", "0")
    with pytest.raises(ValueError, match="REPRO_TORCH_TRACE_SHARDS"):
        trace_shard.default_shard_count()
    monkeypatch.delenv("REPRO_TORCH_TRACE_SHARDS")
    # The reference's variable is not the port's.
    monkeypatch.setenv("REPRO_TRACE_SHARDS", "3")
    assert trace_shard.default_shard_count() >= 1
    monkeypatch.delenv("REPRO_TRACE_SHARDS")
    assert trace_shard.default_shard_count() >= 1


def test_oversized_vertex_space_refused():
    with pytest.raises(NotImplementedError, match="int64"):
        trace_shard.sharded_power_law_factorization(
            n_nodes=trace_shard.MAX_KEY_NODES + 1, n_edges=10)
    assert trace_shard.MAX_KEY_NODES == j_trace_shard.MAX_KEY_NODES


# ---------------------------------------------------------------------------
# The registry, the front door and the disk cache.
# ---------------------------------------------------------------------------
def test_sharded_dataset_is_planner_transparent():
    params = {"n_nodes": 900.0, "n_edges": 6000.0, "seed": 2.0,
              "alpha": 1.4}
    assert "power_law_sharded" in trace_dataset_names()
    res_sharded = evaluate_scenario(Scenario.trace(
        "engn", dataset="power_law_sharded", params=params,
        N=30.0, T=5.0, tile_vertices=300.0), device="cpu")
    res_stream = evaluate_scenario(Scenario.trace(
        "engn", dataset="power_law_stream", params=params,
        N=30.0, T=5.0, tile_vertices=300.0), device="cpu")
    assert res_sharded.total_bits == res_stream.total_bits
    assert res_sharded.breakdown == res_stream.breakdown
    assert res_sharded.n_tiles == res_stream.n_tiles
    # provenance: the result records that an edge-list-free trace backed it
    assert res_sharded.meta["trace"] == {
        "dataset": "power_law_sharded", "n_nodes": 900, "n_edges": 6000,
        "edge_list_free": True}
    assert res_stream.meta["trace"]["edge_list_free"] is False
    j_res = j_evaluate_scenario(JScenario.trace(
        "engn", dataset="power_law_sharded", params=params,
        N=30.0, T=5.0, tile_vertices=300.0))
    assert res_sharded.total_bits == j_res.total_bits
    assert res_sharded.meta == j_res.meta


@pytest.mark.parametrize("dataset", ["power_law_stream", "power_law"])
def test_trace_result_meta_equals_reference(dataset):
    """Every key of a trace result's ``meta`` equals the reference's,
    ``edge_list_free`` among them."""
    params = {"n_nodes": 700.0, "n_edges": 4000.0, "seed": 3.0}
    kw = dict(dataset=dataset, params=params, N=30.0, T=5.0,
              tile_vertices=128.0)
    got = evaluate_scenario(Scenario.trace("hygcn", **kw), device="cpu")
    expect = j_evaluate_scenario(JScenario.trace("hygcn", **kw))
    assert got.meta == expect.meta
    assert got.meta["trace"]["edge_list_free"] is False
    assert got.total_bits == expect.total_bits


def test_sharded_dataset_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    params = {"n_nodes": 800, "n_edges": 5000, "seed": 4, "alpha": 1.4}
    clear_trace_cache()
    t1 = resolve_trace_dataset("power_law_sharded", params)
    s1 = t1.schedule(200, device="cpu")
    assert len(list(tmp_path.rglob("*.graph"))) == 1
    # factorization-only payload: no edge-list parts on disk
    assert not list(tmp_path.rglob("*.graph/senders.npy"))
    assert list(tmp_path.rglob("*.graph/fact_u_snd.npy"))
    clear_trace_cache()
    t2 = resolve_trace_dataset("power_law_sharded", params)
    assert t2 is not t1
    # a warm resolve defers the factorization's finish and memory-maps the
    # stored arrays
    assert t2._fact is None and t2._fact_source is not None
    assert isinstance(t2.row_ptr, np.memmap)
    assert t2.n_edges == 5000 and not t2.has_edge_list
    s2 = t2.schedule(321, device="cpu")
    ref = resolve_trace_dataset(
        "power_law_stream", params).schedule_reference(321)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(s2, f), getattr(ref, f))
    # the schedule stored by t1 round-trips too
    s3 = t2.schedule(200, device="cpu")
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(s3, f), getattr(s1, f))
    clear_trace_cache()


def test_warm_resolve_is_mmap_lazy_for_stream_dataset(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    params = {"n_nodes": 600, "n_edges": 4000, "seed": 8}
    clear_trace_cache()
    t1 = resolve_trace_dataset("power_law_stream", params)
    ref = t1.schedule(150, device="cpu")
    clear_trace_cache()
    t2 = resolve_trace_dataset("power_law_stream", params)
    for name in ("senders", "receivers", "row_ptr"):
        assert isinstance(getattr(t2, name), np.memmap), name
    # edge list present -> the oracle still runs on the warm trace
    got = t2.schedule_reference(150)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    clear_trace_cache()


# ---------------------------------------------------------------------------
# Typed traces (the sharded case of tests/test_hetero.py).
# ---------------------------------------------------------------------------
def test_typed_sharded_counts_bit_match_single_host():
    tr = resolve_trace_dataset("typed_blocks", TYPED_PARAMS)
    assert isinstance(tr, TypedGraphTrace)
    j_tr = j_resolve("typed_blocks", TYPED_PARAMS)
    cap = 64
    n_tiles, K = tr.relation(0)._geometry(cap)
    for n_shards in (1, 3, 7):
        halo, remote = trace_shard.typed_sharded_schedule_counts(
            tr, K, n_tiles, n_shards=n_shards)
        assert halo.shape == (tr.n_relations, n_tiles)
        for r in range(tr.n_relations):
            s = tr.relation(r).schedule(cap, device="cpu")
            assert np.array_equal(halo[r], s.halo_counts.astype(np.int64))
            assert np.array_equal(remote[r],
                                  s.remote_edge_counts.astype(np.int64))
        j_halo, j_remote = j_trace_shard.typed_sharded_schedule_counts(
            j_tr, K, n_tiles, n_shards=n_shards)
        assert np.array_equal(halo, j_halo)
        assert np.array_equal(remote, j_remote)
