"""The port's exact-trace path against the JAX package's.

The same seeded numpy inputs go through the reference (its NumPy engine,
its jitted ``engine="jax"`` path and its Pallas segment reduce in interpret
mode, as the reference's own tests run them) and through the port on the
CPU, where kernel K4's wrapper takes its plain version.  Schedule counts
are integers and must be bit-identical.  On the card the ``gpu``-marked
tests hold the CUDA kernel against its plain version; here they skip.
"""

import numpy as np
import pytest
import torch

from repro.core import trace as jtrace
from repro.data import synthetic as jsynthetic
from repro.kernels import segment_reduce as jsr
from repro_torch.core import trace as ttrace
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels import ops, segment_reduce as sr

#: The reference battery's dataset parameters (tests/test_trace_engine.py).
DATASET_PARAMS = {
    "power_law": {"n_nodes": 1200, "n_edges": 9000, "seed": 1, "alpha": 1.5},
    "power_law_stream": {"n_nodes": 1200, "n_edges": 9000, "seed": 1,
                         "alpha": 1.5},
    "power_law_sharded": {"n_nodes": 1200, "n_edges": 9000, "seed": 1,
                          "alpha": 1.5},
    "cora": {},
    "molecule": {"batch": 16, "n_nodes": 12, "n_edges": 30},
    "ring_of_tiles": {"n_nodes": 512, "n_tiles": 8},
}
COUNT_FIELDS = ("vertex_counts", "edge_counts", "halo_counts",
                "remote_edge_counts")


def _pow2_caps(V):
    return sorted({max(1, V >> i) for i in range(1, 11, 2)} | {V})


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    """Neither package's datasets touch an on-disk cache unless a test
    points one at its ``tmp_path``."""
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pair_tensors(trace, device="cpu"):
    u_snd, u_rcv, u_new_src, mp = trace._pair_factorization()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (u_snd, u_rcv, u_new_src, np.diff(mp)))


def _np(t):
    return t.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# K4's plain version against the reference's jnp and Pallas segment reduce.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["power_law", "molecule", "ring_of_tiles"])
def test_schedule_counts_match_reference_kernels(name):
    ref = jtrace.resolve_trace_dataset(name, DATASET_PARAMS[name])
    u_snd, u_rcv, u_new_src, mp = ref._pair_factorization()
    mult = np.diff(mp)
    tensors = _pair_tensors(ref)
    for cap in _pow2_caps(ref.n_nodes)[:3]:
        oracle = ref.schedule_reference(cap)
        K, n_tiles = oracle.K, oracle.n_tiles
        halo, cut = ops.schedule_counts(*tensors, K, n_tiles)
        assert halo.dtype == cut.dtype == torch.int64
        j_halo, j_cut = jsr.schedule_counts(u_snd, u_rcv, u_new_src, mult,
                                            K, n_tiles)
        p_halo, p_cut = jsr.schedule_counts_pallas(
            u_snd, u_rcv, u_new_src, mult, K, n_tiles, interpret=True)
        for expect_halo, expect_cut in ((j_halo, j_cut), (p_halo, p_cut),
                                        (oracle.halo_counts,
                                         oracle.remote_edge_counts)):
            np.testing.assert_array_equal(_np(halo),
                                          np.asarray(expect_halo, np.float64))
            np.testing.assert_array_equal(_np(cut),
                                          np.asarray(expect_cut, np.float64))


def test_boundary_flags_match_reference():
    rng = np.random.default_rng(3)
    tile = np.sort(rng.integers(0, 9, 300)).astype(np.int32)
    new_src = rng.random(300) < 0.1
    got = sr.boundary_flags(torch.from_numpy(new_src), torch.from_numpy(tile))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsr.boundary_flags(new_src, tile)))
    assert sr.boundary_flags(torch.zeros(0, dtype=torch.bool),
                             torch.zeros(0, dtype=torch.int32)).shape == (0,)


def test_schedule_counts_rejects_bad_operands():
    snd = torch.zeros(4, dtype=torch.int32)
    flags = torch.zeros(4, dtype=torch.bool)
    mult = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 or int64"):
        sr.schedule_counts_plain(snd, snd.long(), flags, mult, 2, 2)
    with pytest.raises(ValueError, match="mult must be int64"):
        sr.schedule_counts_plain(snd, snd, flags, mult.int(), 2, 2)
    with pytest.raises(ValueError, match="one length"):
        sr.schedule_counts_plain(snd, snd[:3], flags, mult, 2, 2)
    with pytest.raises(ValueError, match="K >= 1"):
        sr.schedule_counts_plain(snd, snd, flags, mult, 0, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sr.schedule_counts(snd, snd, flags, mult, 2, 2)


def test_empty_pair_list_counts_zero_without_a_launch():
    ops.reset_launches()
    z32 = torch.zeros(0, dtype=torch.int32)
    halo, cut = ops.schedule_counts(z32, z32, torch.zeros(0, dtype=torch.bool),
                                    torch.zeros(0, dtype=torch.int64), 3, 5)
    assert halo.tolist() == cut.tolist() == [0] * 5
    assert ops.LAUNCHES["segment_reduce.schedule_counts"] == 0


# ---------------------------------------------------------------------------
# K4's host-side plan: magic division and the flush route.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("K", [1, 2, 3, 7, 15, 16, 244, 976, 62_500, 500_000,
                               2**31 - 1, 2**31 + 1, 2**40 + 3, 2**62 + 1,
                               2**63 - 1])
def test_div_magic_matches_floor_division(K, bits):
    top = 2 ** (bits - 1) - 1           # the largest id of the index type
    if K > top:
        with pytest.raises(ValueError, match="must lie"):
            sr.div_magic(K, bits)
        return
    m, s = sr.div_magic(K, bits)
    assert m < 2**64 and (bits == 64 or m <= 2**32)
    rng = np.random.default_rng(K % 1000)
    xs = {0, 1, K - 1, K, K + 1, 2 * K - 1, 2 * K, top, top - 1,
          top // K * K, top // K * K - 1}
    xs |= {int(v) for v in rng.integers(0, top, 200, dtype=np.int64)}
    for x in sorted(v for v in xs if 0 <= v <= top):
        assert (x * m) >> s == x // K, x
    if bits == 32:                       # the kernel's product fits 63 bits
        assert top * m < 2**63


#: (n_tiles, total multiplicity or None, shared?, packed?) at the route
#: boundaries: 8192 packed bins (8 bytes) or 4096 unpacked (16 bytes) fill
#: the 64 KB histogram; both fields of a packed word must stay below 2^32.
ROUTE_CASES = [
    (1, 10**6, True, True),
    (8192, 10**6, True, True),
    (8193, 10**6, False, True),
    (4096, None, True, False),
    (4097, None, False, False),
    (65_536, 10**6, False, True),
    (65_536, None, False, False),
    (4096, 2**32 - 1, True, True),
    (4096, 2**32, True, False),
    (3, 2**53 + 4097, True, False),
]


@pytest.mark.parametrize("n_tiles,total,shared,packed", ROUTE_CASES)
def test_k4_route_at_the_field_and_memory_limits(n_tiles, total, shared,
                                                 packed):
    route = sr.k4_route(200_000, n_tiles, total)
    assert (route.shared, route.packed) == (shared, packed)
    assert route.pack_shift == (sr.PACK_SHIFT if packed else 0)
    assert route.code == (1 if shared else 0) | (2 if packed else 0)


def test_k4_route_needs_the_pair_count_below_2p32_to_pack():
    assert sr.k4_route(2**32 - 1, 16, 10).packed
    assert not sr.k4_route(2**32, 16, 10).packed
    assert not sr.k4_route(10, 16, -1).packed


def _route_pairs(seed=5, V=1 << 18, U=200_000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, V * V, U, dtype=np.int64))
    snd, rcv = (keys // V).astype(np.int32), (keys % V).astype(np.int32)
    new_src = np.concatenate([[True], snd[1:] != snd[:-1]])
    mult = rng.integers(1, 4, snd.size).astype(np.int64)
    return V, (snd, rcv, new_src, mult)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tiles,total,shared,packed", ROUTE_CASES)
def test_cuda_schedule_counts_on_every_route(n_tiles, total, shared, packed,
                                             cuda_device):
    V, arrays = _route_pairs()
    if total is not None and total > 10**6:
        arrays[3][len(arrays[3]) // 2] += total - int(arrays[3].sum())
    cpu = tuple(torch.from_numpy(a) for a in arrays)
    bound = None if total is None else int(arrays[3].sum())
    route = sr.k4_route(cpu[0].shape[0], n_tiles, bound)
    assert (route.shared, route.packed) == (shared, packed)
    K = -(-V // n_tiles)
    got = sr.schedule_counts(*(t.to(cuda_device) for t in cpu), K, n_tiles,
                             bound)
    expect = sr.schedule_counts_plain(*cpu, K, n_tiles)
    for g, e in zip(got, expect):
        assert torch.equal(g.cpu(), e)


# ---------------------------------------------------------------------------
# GraphTrace: both port engines against the reference, every dataset.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("name", sorted(DATASET_PARAMS))
def test_trace_schedules_match_reference(name, engine):
    ref = jtrace.resolve_trace_dataset(name, DATASET_PARAMS[name])
    port = ttrace.resolve_trace_dataset(name, DATASET_PARAMS[name])
    port.clear_schedules()  # the LRU is engine-blind
    np.testing.assert_array_equal(port.senders, ref.senders)
    np.testing.assert_array_equal(port.receivers, ref.receivers)
    caps = _pow2_caps(ref.n_nodes)
    ref.clear_schedules()
    jax_scheds = ref.schedules(caps, engine="jax")
    scheds = port.schedules(caps, engine=engine, device="cpu")
    # A sharded build is factorization-only (no oracle); its graph is by
    # contract power_law_stream's for equal parameters.
    oracle_trace = ref if ref.has_edge_list else jtrace.resolve_trace_dataset(
        "power_law_stream", DATASET_PARAMS[name])
    assert port.has_edge_list == ref.has_edge_list
    for cap, got, jax_s in zip(caps, scheds, jax_scheds):
        oracle = oracle_trace.schedule_reference(cap)
        assert (got.n_tiles, got.K, got.capacity) == (
            oracle.n_tiles, oracle.K, oracle.capacity)
        for f in COUNT_FIELDS:
            for expect in (jax_s, oracle):
                np.testing.assert_array_equal(
                    getattr(got, f), getattr(expect, f),
                    err_msg=f"{name} cap={cap} field={f}")
        for hdf in (0.0, 0.1, 1.0):
            np.testing.assert_array_equal(got.cache_hit_fraction(hdf),
                                          oracle.cache_hit_fraction(hdf))
        assert got.stats() == oracle.stats()
    ref.clear_schedules()


def test_device_factorization_moves_once_per_trace():
    port = ttrace.GraphTrace(*_small_edges(), 200)
    port.schedules([7, 50], device="cpu")
    first = port._device_factorization(torch.device("cpu"))
    port.schedules([3, 9, 100], device="cpu")
    assert list(port._device_fact) == ["cpu"]
    assert all(a is b for a, b in zip(
        first, port._device_factorization(torch.device("cpu"))))


def _small_edges():
    rng = np.random.default_rng(5)
    return rng.integers(0, 200, 1500), rng.integers(0, 200, 1500)


def test_schedule_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = ttrace.GraphTrace(*_small_edges(), 200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.schedules([50])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.schedule(50, engine="torch")
    assert port.schedule(50, engine="numpy").n_tiles == 4
    with pytest.raises(ValueError, match="unknown trace engine"):
        port.schedules([50], engine="jax")


def test_factorization_matches_reference_across_dtypes():
    snd, rcv = _small_edges()
    for dt in (np.int32, np.int64):
        ref = jtrace.GraphTrace(snd.astype(dt), rcv.astype(dt), 200)
        port = ttrace.GraphTrace(snd.astype(dt), rcv.astype(dt), 200)
        for a, b in zip(port._pair_factorization(), ref._pair_factorization()):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(port.row_ptr, ref.row_ptr)
        np.testing.assert_array_equal(port.out_degrees(), ref.out_degrees())


# ---------------------------------------------------------------------------
# The 2^53 boundary: int64 end to end, against a Python-int oracle.
# ---------------------------------------------------------------------------
def _python_int_schedule_oracle(u_snd, u_rcv, mult, V, cap):
    n_tiles = -(-V // cap)
    edge = [0] * n_tiles
    remote = [0] * n_tiles
    halo_sources = [set() for _ in range(n_tiles)]
    for s, r, m in zip(u_snd, u_rcv, mult):
        t = int(r) // cap
        edge[t] += int(m)
        if int(s) // cap != t:
            remote[t] += int(m)
            halo_sources[t].add(int(s))
    return edge, remote, [len(h) for h in halo_sources]


def _dense_pairs(V, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, V * V, size=4 * V))
    return (keys // V).astype(np.int64), (keys % V).astype(np.int64)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
@pytest.mark.parametrize("total", [2**53 - 1, 2**53 + 4097, 10**8 + 7],
                         ids=["2p53-1", "2p53+4097", "1e8"])
def test_schedule_counts_exact_at_2p53_boundary(total, engine):
    V, cap = 96, 32
    u_snd, u_rcv = _dense_pairs(V, seed=11)
    U = u_snd.size
    mult = np.ones(U, dtype=np.int64)
    mult[U // 3] = total - (U - 1)  # a 2^53-scale hot pair
    prefix = np.zeros(U + 1, dtype=np.int64)
    np.cumsum(mult, out=prefix[1:])
    port = ttrace.GraphTrace.from_factorization(V, u_snd, u_rcv, prefix)
    ref = jtrace.GraphTrace.from_factorization(V, u_snd, u_rcv, prefix)
    assert port.n_edges == total
    edge, remote, halo = _python_int_schedule_oracle(u_snd, u_rcv, mult, V,
                                                     cap)
    sched = port.schedule(cap, engine=engine, device="cpu")
    assert list(sched.edge_counts) == [float(x) for x in edge]
    assert list(sched.remote_edge_counts) == [float(x) for x in remote]
    assert [int(x) for x in sched.halo_counts] == halo
    expect = ref.schedule(cap)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(sched, f), getattr(expect, f))
    # The kernel's plain version itself stays int64: exact past 2^53.
    _, cut = ops.schedule_counts(*_pair_tensors(port), sched.K, sched.n_tiles)
    assert cut.tolist() == remote


# ---------------------------------------------------------------------------
# The generators: bit-identical edge lists from the same arguments.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("self_loops", [True, False])
def test_power_law_graph_matches_reference(self_loops):
    kw = dict(n_nodes=500, n_edges=4000, d_feat=3, alpha=1.7,
              self_loops=self_loops)
    a, b = (tsynthetic.power_law_graph(4, **kw),
            jsynthetic.power_law_graph(4, **kw))
    for f in ("senders", "receivers", "node_feat", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.n_nodes == b.n_nodes and a.n_edges == b.n_edges


@pytest.mark.parametrize("chunk_edges", [tsynthetic.POWER_LAW_STREAM_CHUNK,
                                         300_000])
def test_power_law_edges_match_reference(chunk_edges):
    # Crosses one generation block boundary (2^20 edges).
    kw = dict(n_nodes=20_000, n_edges=(1 << 20) + 1234, alpha=1.6,
              chunk_edges=chunk_edges)
    for a, b in zip(tsynthetic.power_law_edges(2, **kw),
                    jsynthetic.power_law_edges(2, **kw)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    shards = [np.concatenate(x) for x in zip(*(
        tsynthetic.power_law_edges(2, shard=s, n_shards=2, **kw)
        for s in range(2)))]
    assert shards[0].size == kw["n_edges"]


def test_ring_and_molecule_generators_match_reference():
    a = tsynthetic.ring_of_tiles_graph(n_nodes=120, n_tiles=4)
    b = jsynthetic.ring_of_tiles_graph(n_nodes=120, n_tiles=4)
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.receivers, b.receivers)
    ma = tsynthetic.molecule_batch(1, 2, batch=5, n_nodes=9, n_edges=20,
                                   d_feat=2)
    mb = jsynthetic.molecule_batch(1, 2, batch=5, n_nodes=9, n_edges=20,
                                   d_feat=2)
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k])
    with pytest.raises(ValueError, match="must divide"):
        tsynthetic.ring_of_tiles_graph(n_nodes=100, n_tiles=3)


# ---------------------------------------------------------------------------
# Registry and cache behaviour carried over from the reference.
# ---------------------------------------------------------------------------
def test_dataset_registry_and_cache_keys():
    assert ttrace.trace_dataset_names() == (
        "cora", "molecule", "power_law", "power_law_sharded",
        "power_law_stream", "ring_of_tiles", "typed_blocks", "typed_cora",
        "typed_power_law")
    assert ttrace.trace_dataset_names() == jtrace.trace_dataset_names()
    a = ttrace.resolve_trace_dataset("ring_of_tiles",
                                     {"n_nodes": 64, "n_tiles": 4})
    b = ttrace.resolve_trace_dataset("ring_of_tiles",
                                     {"n_nodes": 64.0, "n_tiles": np.int64(4)})
    assert a is b
    assert ttrace._canonical_params({"n": 2.0, "x": {"y": [1.0]}}) == (
        jtrace._canonical_params({"n": 2.0, "x": {"y": [1.0]}}))
    with pytest.raises(KeyError, match="unknown trace dataset"):
        ttrace.resolve_trace_dataset("no_such_dataset")
    with pytest.raises(ValueError, match="bad parameters"):
        ttrace.resolve_trace_dataset("ring_of_tiles", {"bogus": 1})
    ttrace.clear_trace_cache()
    assert ttrace.trace_cache_info()["entries"] == 0


def test_from_factorization_and_guards_match_reference():
    u_snd, u_rcv = _dense_pairs(64, seed=2)
    prefix = np.arange(u_snd.size + 1, dtype=np.int64) * 2
    port = ttrace.GraphTrace.from_factorization(64, u_snd, u_rcv, prefix)
    ref = jtrace.GraphTrace.from_factorization(64, u_snd, u_rcv, prefix)
    assert not port.has_edge_list
    np.testing.assert_array_equal(port.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(port.in_degrees(), ref.in_degrees())
    np.testing.assert_array_equal(port.out_degrees(), ref.out_degrees())
    with pytest.raises(RuntimeError, match="materialized edge list"):
        port.schedule_reference(16)
    with pytest.raises(ValueError, match="edge endpoints"):
        ttrace.GraphTrace([0, 5], [1, 2], 4)
    with pytest.raises(ValueError, match="whole number"):
        port.schedule(2.5, device="cpu")


# ---------------------------------------------------------------------------
# The content-addressed disk cache (twins of the reference's four tests, the
# keys held to the reference's, and the two packages' roots kept apart).
# ---------------------------------------------------------------------------
def test_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    params = {"n_nodes": 700, "n_edges": 4200, "seed": 9, "alpha": 1.4}
    ttrace.clear_trace_cache()
    ttrace.reset_trace_stats()
    t1 = ttrace.resolve_trace_dataset("power_law", params)
    s1 = t1.schedule(128, device="cpu")
    # one graph part-directory and one schedule npz
    assert len(list(tmp_path.rglob("*.graph"))) == 1
    assert len(list(tmp_path.rglob("*.npz"))) == 1
    ttrace.clear_trace_cache()
    t2 = ttrace.resolve_trace_dataset("power_law", params)
    assert t2 is not t1
    np.testing.assert_array_equal(t2.senders, t1.senders)
    np.testing.assert_array_equal(t2.receivers, t1.receivers)
    np.testing.assert_array_equal(t2.row_ptr, t1.row_ptr)
    # the schedule comes from disk (no K4 pass, no sort) and still answers
    # cache-hit queries through the lazily rebuilt pair provider
    s2 = t2.schedule(128, device="cpu")
    stats = ttrace.trace_cache_info()["stats"]
    assert stats == {"factorizations": 1, "schedule_computes": 1,
                     "schedule_cache_hits": 0, "schedule_disk_hits": 1,
                     "trace_builds": 1}
    assert s2.counts_dict().keys() == s1.counts_dict().keys()
    for f, v in s1.counts_dict().items():
        np.testing.assert_array_equal(s2.counts_dict()[f], v)
        assert np.asarray(s2.counts_dict()[f]).dtype == np.asarray(v).dtype
    np.testing.assert_array_equal(s2.cache_hit_fraction(0.1),
                                  s1.cache_hit_fraction(0.1))
    ref = t2.schedule_reference(128)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(s2, f), getattr(ref, f))
    # a new capacity on the disk-loaded graph: K4's pass over the stored
    # factorization equals the reference engine's schedule
    s3 = t2.schedule(64, device="cpu")
    expect = jtrace.resolve_trace_dataset("power_law", params).schedule(64)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(s3, f), getattr(expect, f))
    assert ttrace.trace_cache_info()["stats"]["factorizations"] == 1
    ttrace.clear_trace_cache()


def test_disk_cache_disabled_and_tokenless(tmp_path, monkeypatch):
    from repro_torch.core import schedule_cache
    params = {"n_nodes": 400, "n_edges": 2000, "seed": 1}
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    ttrace.clear_trace_cache()
    ttrace.resolve_trace_dataset("power_law", params).schedule(64,
                                                               device="cpu")
    assert schedule_cache.cache_root() is None
    # token-less datasets never write entries, even with the cache on
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    ttrace.clear_trace_cache()
    ttrace.resolve_trace_dataset(
        "ring_of_tiles", {"n_nodes": 400, "n_tiles": 4}).schedule(
            64, device="cpu")
    assert list(tmp_path.rglob("*.npz")) == []
    assert list(tmp_path.rglob("*.graph")) == []
    ttrace.clear_trace_cache()


def test_disk_cache_min_edges_threshold(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "5000")
    ttrace.clear_trace_cache()
    ttrace.resolve_trace_dataset(
        "power_law", {"n_nodes": 300, "n_edges": 1000, "seed": 0}).schedule(
            64, device="cpu")
    assert list(tmp_path.rglob("*.npz")) == []
    assert list(tmp_path.rglob("*.graph")) == []
    ttrace.clear_trace_cache()


def test_disk_cache_corrupt_entry_is_a_miss(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_MIN_EDGES", "0")
    params = {"n_nodes": 500, "n_edges": 2500, "seed": 2}
    ttrace.clear_trace_cache()
    t1 = ttrace.resolve_trace_dataset("power_law", params)
    s1 = t1.schedule(100, device="cpu")
    for f in tmp_path.rglob("*.npz"):
        f.write_bytes(b"not an npz")
    for f in tmp_path.rglob("*.graph/*"):
        f.write_bytes(b"garbage")  # torn npy parts and a torn meta.json
    ttrace.clear_trace_cache()
    ttrace.reset_trace_stats()
    t2 = ttrace.resolve_trace_dataset("power_law", params)  # rebuilds
    np.testing.assert_array_equal(t2.senders, t1.senders)
    s2 = t2.schedule(100, device="cpu")  # the torn schedule is a miss
    assert ttrace.trace_cache_info()["stats"]["trace_builds"] == 1
    assert ttrace.trace_cache_info()["stats"]["schedule_computes"] == 1
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(s2, f), getattr(s1, f))
    # the damaged entries were dropped and stored again, clean
    ttrace.clear_trace_cache()
    t3 = ttrace.resolve_trace_dataset("power_law", params)
    np.testing.assert_array_equal(np.asarray(t3.row_ptr), t1.row_ptr)
    t3.schedule(100, device="cpu")
    assert ttrace.trace_cache_info()["stats"]["schedule_disk_hits"] == 1
    ttrace.clear_trace_cache()


def test_disk_cache_keys_match_reference(tmp_path, monkeypatch):
    """The same dataset, parameters and token give the same keys in both
    packages, and each package, left at its defaults, writes them under its
    own root: neither reads the other's entries."""
    from repro.core import schedule_cache as jcache
    from repro_torch.core import schedule_cache as tcache
    for params in ({"n_nodes": 600, "n_edges": 3000, "seed": 4},
                   {"n_nodes": 600.0, "n_edges": 3000.0, "seed": 4.0,
                    "alpha": 1.6}):
        canonical = ttrace._canonical_params(params)
        assert canonical == jtrace._canonical_params(params)
        assert tcache.graph_cache_key("power_law", canonical, "v1") == \
            jcache.graph_cache_key("power_law", canonical, "v1")
        for cap in (1, 64, 600):
            assert tcache.schedule_cache_key(
                "power_law", canonical, "v1", cap) == \
                jcache.schedule_cache_key("power_law", canonical, "v1", cap)
    assert tcache.schedule_cache_key("power_law", "{}", "v1", 8) != \
        tcache.schedule_cache_key("power_law", "{}", "v2", 8)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("REPRO_TRACE_CACHE")
    monkeypatch.delenv("REPRO_TORCH_TRACE_CACHE")
    for var in ("REPRO_TRACE_CACHE_MIN_EDGES",
                "REPRO_TORCH_TRACE_CACHE_MIN_EDGES"):
        monkeypatch.setenv(var, "0")
    params = {"n_nodes": 600, "n_edges": 3000, "seed": 4}
    for mod in (ttrace, jtrace):
        mod.clear_trace_cache()
    ttrace.resolve_trace_dataset("power_law", params).schedule(
        64, device="cpu")
    jtrace.resolve_trace_dataset("power_law", params).schedule(64)
    port_root = tmp_path / ".cache" / "repro-torch-trace"
    ref_root = tmp_path / ".cache" / "repro-trace"
    assert tcache.cache_root() == port_root
    assert jcache.cache_root() == ref_root
    listing = {root: sorted(str(p.relative_to(root))
                            for p in root.rglob("*")
                            if p.suffix in (".graph", ".npz"))
               for root in (port_root, ref_root)}
    assert len(listing[port_root]) == 2
    assert listing[port_root] == listing[ref_root]
    for mod in (ttrace, jtrace):
        mod.clear_trace_cache()


# ---------------------------------------------------------------------------
# On the card: K4 against its plain version, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DATASET_PARAMS))
def test_cuda_schedule_counts_match_plain_version(name, cuda_device):
    port = ttrace.resolve_trace_dataset(name, DATASET_PARAMS[name])
    dev, cpu = _pair_tensors(port, cuda_device), _pair_tensors(port)
    for cap in _pow2_caps(port.n_nodes):
        n_tiles, K = port._geometry(cap)
        got = sr.schedule_counts(*dev, K, n_tiles)
        expect = sr.schedule_counts_plain(*cpu, K, n_tiles)
        for g, e in zip(got, expect):
            assert torch.equal(g.cpu(), e)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_schedule_counts_int64_and_2p53(cuda_device):
    V = 3_000_000_000  # ids past int32: the int64-index instantiation
    u_snd = torch.tensor([0, 5, 2_999_999_999, 2_999_999_999])
    u_rcv = torch.tensor([2_999_999_998, 7, 1, 2_000_000_000])
    new_src = torch.tensor([True, True, True, False])
    mult = torch.tensor([3, 1, 2**53 + 5, 1])
    ops.reset_launches()
    for cap in (V // 2, V // 1000, 12345):
        n_tiles = -(-V // cap)
        K = -(-V // n_tiles)
        cpu = (u_snd, u_rcv, new_src, mult)
        got = ops.schedule_counts(*(t.to(cuda_device) for t in cpu), K,
                                  n_tiles)
        expect = sr.schedule_counts_plain(*cpu, K, n_tiles)
        for g, e in zip(got, expect):
            assert torch.equal(g.cpu(), e)
    assert ops.LAUNCHES["segment_reduce.schedule_counts"] == 3
