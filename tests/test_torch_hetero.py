"""Typed traces, the relational model, hetero and minibatch scenarios of the
port, held to the reference (the twin of ``tests/test_hetero.py``).

The same typed datasets are built by both packages from the same seeds and
must be the same edge lists; every per-relation schedule, every relational
term and every scenario total of the port must equal the reference's bit
for bit (``np.array_equal``, never ``isclose``).  On the CPU the torch
engine runs K4's plain version, which must equal the NumPy engine.  The
sharded case of the reference's battery is twinned in
``tests/test_torch_trace_shard.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.api.planner import evaluate_groups as j_evaluate_groups
from repro.api.planner import evaluate_scenarios as j_evaluate
from repro.api.scenario import Scenario as JScenario
from repro.api.templates import template as j_template
from repro.core.compose import FullGraphParams as JFullGraphParams
from repro.core.compose import RelationalGraphModel as JRelationalGraphModel
from repro.core.trace import resolve_trace_dataset as j_resolve
from repro.data import sampler as jsampler
from repro_torch.api import cli, evaluate_groups, template
from repro_torch.api.planner import evaluate_scenarios
from repro_torch.api.scenario import Composition, Scenario, load_scenarios
from repro_torch.core import registry
from repro_torch.core import trace as ttrace
from repro_torch.core.compose import (COMPOSITION_FORMS, FullGraphParams,
                                      MultiLayerModel, RelationalGraphModel,
                                      TiledGraphModel, _pairwise_sum)
from repro_torch.core.notation import (CompositionHardwareParams,
                                       RelationalScheduleParams)
from repro_torch.core.trace import (GraphTrace, TypedGraphTrace,
                                    resolve_trace_dataset)
from repro_torch.data import sampler as sampler_mod
from repro_torch.data.sampler import (build_csr, csr_from_trace,
                                      minibatch_oracle_counts,
                                      minibatch_schedule)
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parents[1]
HETERO_SMOKE = REPO / "examples" / "scenarios" / "hetero_smoke.json"
TYPED_PARAMS = {"n_relations": 3, "n_nodes": 200, "n_edges": 900, "seed": 1}
CAPS = (64.0, 100.0, 17.0)
MB_PARAMS = {"n_nodes": 2000, "n_edges": 16000, "seed": 1}
MB_KW = dict(batch_nodes=64, fanout=(10, 5), n_batches=8, seed=0)
SCHEDULE_FIELDS = ("vertex_counts", "edge_counts", "halo_counts",
                   "remote_edge_counts")


@pytest.fixture(scope="module")
def typed_blocks() -> TypedGraphTrace:
    tr = resolve_trace_dataset("typed_blocks", TYPED_PARAMS)
    assert isinstance(tr, TypedGraphTrace)
    return tr


def _terms_by_key(output):
    return {(t.name, t.hierarchy): (np.asarray(t.data_bits, np.float64),
                                    np.asarray(t.iterations, np.float64))
            for t in output.terms}


def _rloop_combined(tr, make_inner, N=30.0, T=5.0):
    """R-loop of homogeneous per-relation evaluations (torch engine, K4's
    plain version), combined the way the relational model reduces its
    relation axis (pairwise)."""
    outs = []
    for r in range(tr.n_relations):
        rel = tr.relation(r)
        full_r = FullGraphParams(V=tr.n_nodes, E=rel.n_edges, N=N, T=T)
        m = TiledGraphModel(make_inner(r), tile_vertices=CAPS, trace=rel,
                            device="cpu")
        outs.append(_terms_by_key(m.evaluate(full_r)))
    keys = list(dict.fromkeys(k for o in outs for k in o))
    zeros = np.zeros(len(CAPS))
    combined = {}
    for k in keys:
        cols = [o.get(k, (zeros, zeros)) for o in outs]
        combined[k] = (_pairwise_sum(np.stack([c[0] for c in cols], axis=-1)),
                       _pairwise_sum(np.stack([c[1] for c in cols], axis=-1)))
    return combined


def _assert_same_terms(got, want):
    zeros = np.zeros(len(CAPS))
    for k in dict.fromkeys(list(want) + list(got)):
        gb, gi = got.get(k, (zeros, zeros))
        wb, wi = want.get(k, (zeros, zeros))
        assert np.array_equal(gb, wb), (k, gb, wb)
        assert np.array_equal(gi, wi), (k, gi, wi)


def _reference_relational(dataflow, **kw):
    """The reference's RelationalGraphModel on its own typed_blocks."""
    tr = j_resolve("typed_blocks", TYPED_PARAMS)
    full = JFullGraphParams(V=tr.n_nodes, E=tr.n_edges, N=30.0, T=5.0)
    return _terms_by_key(JRelationalGraphModel(
        dataflow, tile_vertices=CAPS, trace=tr, **kw).evaluate(full))


# ---------------------------------------------------------------------------
# The typed datasets and the shared factorization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,params", [
    ("typed_blocks", TYPED_PARAMS),
    ("typed_power_law", TYPED_PARAMS),
    ("typed_cora", {"n_relations": 4, "seed": 2}),
])
def test_typed_datasets_and_factorization_equal_reference(name, params):
    port, ref = resolve_trace_dataset(name, params), j_resolve(name, params)
    assert (port.n_nodes, port.n_edges, port.n_relations) == (
        ref.n_nodes, ref.n_edges, ref.n_relations)
    for f in ("senders", "receivers", "rels"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    for a, b in zip(port._typed_factorization(), ref._typed_factorization(),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(port.relation_edge_counts(),
                          ref.relation_edge_counts())


def test_typed_factorization_lexsort_path_equals_composite_key():
    """Past the int64 composite key (R*V^2 > 2^63) the trace takes its
    lexsort fallback; both give the same triples."""
    tr = resolve_trace_dataset("typed_power_law", TYPED_PARAMS)
    big_v = 2**31
    wide = TypedGraphTrace(tr.senders.astype(np.int64),
                           tr.receivers.astype(np.int64), tr.rels, big_v, 3)
    small = TypedGraphTrace(tr.senders.astype(np.int64),
                            tr.receivers.astype(np.int64), tr.rels,
                            tr.n_nodes, 3)
    for a, b in zip(wide._typed_factorization(),
                    small._typed_factorization(), strict=True):
        assert np.array_equal(a, b)


def test_typed_trace_validation_rejections():
    with pytest.raises(ValueError, match="equal length"):
        TypedGraphTrace([0, 1], [1], [0, 0], 3, 1)
    with pytest.raises(ValueError, match="integer"):
        TypedGraphTrace([0.0], [1.0], [0], 3, 1)
    with pytest.raises(ValueError, match="relation ids"):
        TypedGraphTrace([0], [1], [2], 3, 2)
    with pytest.raises(ValueError, match="edge endpoints"):
        TypedGraphTrace([0], [3], [0], 3, 1)
    tr = TypedGraphTrace([0], [1], [0], 3, 2)
    with pytest.raises(ValueError, match="relation must lie"):
        tr.relation(2)
    assert tr.relation(1).n_edges == 0
    assert list(tr.relation_edge_counts()) == [1, 0]
    empty = TypedGraphTrace(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.int64), 4, 2)
    assert list(empty.relation_edge_counts()) == [0, 0]
    assert empty.relation(0).schedule(2, engine="numpy").n_tiles == 2


# ---------------------------------------------------------------------------
# Relational model bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataflow", registry.names())
def test_relational_model_bit_matches_r_loop(typed_blocks, dataflow):
    tr = typed_blocks
    full = FullGraphParams(V=tr.n_nodes, E=tr.n_edges, N=30.0, T=5.0)
    widths = (30.0, 16.0, 5.0)
    cases = [
        (dict(), lambda r: dataflow),
        (dict(widths=widths),
         lambda r: MultiLayerModel(dataflow, widths)),
        (dict(widths=widths, residency="resident"),
         lambda r: MultiLayerModel(dataflow, widths, residency="resident")),
    ]
    for kw, make_inner in cases:
        m = RelationalGraphModel(dataflow, tile_vertices=CAPS, trace=tr,
                                 device="cpu", **kw)
        got = _terms_by_key(m.evaluate(full))
        _assert_same_terms(got, _rloop_combined(tr, make_inner))
        _assert_same_terms(got, _reference_relational(dataflow, **kw))


@pytest.mark.parametrize("dataflow", ("engn", "hygcn"))
def test_relational_model_per_relation_widths_and_residency(typed_blocks,
                                                            dataflow):
    tr = typed_blocks
    full = FullGraphParams(V=tr.n_nodes, E=tr.n_edges, N=30.0, T=5.0)
    w = (np.array([30.0, 20.0, 10.0]), np.array([16.0, 8.0, 12.0]),
         np.array([5.0, 5.0, 5.0]))
    m = RelationalGraphModel(dataflow, tile_vertices=CAPS, trace=tr,
                             widths=w, device="cpu")
    got = _terms_by_key(m.evaluate(full))
    _assert_same_terms(got, _rloop_combined(
        tr, lambda r: MultiLayerModel(dataflow, tuple(x[r] for x in w))))
    _assert_same_terms(got, _reference_relational(dataflow, widths=w))
    res = ("resident", "spill", "resident")
    m = RelationalGraphModel(dataflow, tile_vertices=CAPS, trace=tr,
                             widths=(30.0, 16.0, 5.0), residency=res,
                             device="cpu")
    got = _terms_by_key(m.evaluate(full))
    _assert_same_terms(got, _rloop_combined(
        tr, lambda r: MultiLayerModel(dataflow, (30.0, 16.0, 5.0),
                                      residency=res[r])))
    _assert_same_terms(got, _reference_relational(
        dataflow, widths=(30.0, 16.0, 5.0), residency=res))


def test_relational_model_scalar_capacity_keeps_batch_axis(typed_blocks):
    m = RelationalGraphModel("engn", tile_vertices=64.0, trace=typed_blocks,
                             device="cpu")
    full = FullGraphParams(V=typed_blocks.n_nodes, E=typed_blocks.n_edges,
                           N=30.0, T=5.0)
    out = m.evaluate(full)
    assert np.asarray(out.terms[0].data_bits).shape == (1,)
    assert out.meta["n_relations"] == 3


def test_relational_model_rejections(typed_blocks):
    tr = typed_blocks
    with pytest.raises(TypeError, match="TypedGraphTrace"):
        RelationalGraphModel("engn", tile_vertices=64.0,
                             trace=tr.relation(0))
    with pytest.raises(ValueError, match="1-D capacity"):
        RelationalGraphModel("engn", tile_vertices=np.ones((2, 2)), trace=tr)
    with pytest.raises(ValueError, match=">= 1"):
        RelationalGraphModel("engn", tile_vertices=0.0, trace=tr)
    with pytest.raises(ValueError, match="needs layer widths"):
        RelationalGraphModel("engn", tile_vertices=8.0, trace=tr,
                             residency="resident")
    with pytest.raises(ValueError, match="one policy per relation"):
        RelationalGraphModel("engn", tile_vertices=8.0, trace=tr,
                             widths=(4.0, 4.0), residency=("spill",))
    m = RelationalGraphModel("engn", tile_vertices=8.0, trace=tr,
                             device="cpu")
    with pytest.raises(ValueError, match="ALL relations"):
        m.evaluate(FullGraphParams(V=tr.n_nodes, E=1.0, N=1.0, T=1.0))


# ---------------------------------------------------------------------------
# Typed schedule drift gates
# ---------------------------------------------------------------------------

def test_typed_schedules_bit_match_independent_traces():
    tr = resolve_trace_dataset("typed_power_law", TYPED_PARAMS)
    ref = j_resolve("typed_power_law", TYPED_PARAMS)
    for r in range(tr.n_relations):
        mask = tr.rels == r
        solo = GraphTrace(tr.senders[mask], tr.receivers[mask], tr.n_nodes)
        rel = tr.relation(r)
        assert rel.n_edges == solo.n_edges and not rel.has_edge_list
        for cap in (64, 37):
            a = rel.schedule(cap, device="cpu")
            b = solo.schedule(cap, engine="numpy")
            c = ref.relation(r).schedule(cap)
            d = solo.schedule_reference(cap)
            for f in SCHEDULE_FIELDS:
                for other in (b, c, d):
                    assert np.array_equal(getattr(a, f),
                                          getattr(other, f)), (r, cap, f)


def test_relation_schedules_torch_engine_equals_numpy_engine():
    """The torch engine (K4's plain version on CPU tensors) against the
    NumPy engine, relation by relation; the LRU is engine-blind, so it is
    cleared in between."""
    tr = TypedGraphTrace(*(getattr(resolve_trace_dataset(
        "typed_power_law", TYPED_PARAMS), f)
        for f in ("senders", "receivers", "rels")), 200, 3)
    caps = [100, 50, 25, 12, 6, 3, 1]
    launches = dict(ops.LAUNCHES)
    got = [tr.relation_schedules(c, device="cpu") for c in caps]
    assert dict(ops.LAUNCHES) == launches  # CPU tensors launch nothing
    tr.clear_schedules()
    want = [tr.relation_schedules(c, engine="numpy") for c in caps]
    for g, w in zip(got, want, strict=True):
        assert len(g) == tr.n_relations
        for a, b in zip(g, w, strict=True):
            assert a.n_tiles == b.n_tiles and a.K == b.K
            for f in SCHEDULE_FIELDS:
                assert np.array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="unknown trace engine"):
        tr.relation_schedules(8, engine="jax")


def test_relation_device_factorization_without_an_edge_list():
    """A relation trace is factorization-only; its device copy is the
    slice of the shared sort with the multiplicity prefix rebased."""
    tr = resolve_trace_dataset("typed_power_law", TYPED_PARAMS)
    _, u_snd, u_rcv, mp, rel_ptr = tr._typed_factorization()
    for r in range(tr.n_relations):
        rel = tr.relation(r)
        lo, hi = int(rel_ptr[r]), int(rel_ptr[r + 1])
        snd, rcv, new_src, mult = (t.numpy() for t in
                                   rel._device_factorization("cpu"))
        assert np.array_equal(snd, u_snd[lo:hi])
        assert np.array_equal(rcv, u_rcv[lo:hi])
        assert np.array_equal(mult, np.diff(mp[lo:hi + 1]))
        assert new_src[0] and int(mult.sum()) == rel.n_edges
        assert np.array_equal(rel.in_degrees(), np.bincount(
            tr.receivers[tr.rels == r], minlength=tr.n_nodes))


def test_relation_edge_counts_partition_the_edge_list(typed_blocks):
    counts = typed_blocks.relation_edge_counts()
    assert counts.shape == (typed_blocks.n_relations,)
    assert int(counts.sum()) == typed_blocks.n_edges
    assert np.array_equal(counts, np.bincount(
        typed_blocks.rels, minlength=typed_blocks.n_relations))
    assert typed_blocks.nbytes > 0


# ---------------------------------------------------------------------------
# Minibatch episodes
# ---------------------------------------------------------------------------

def test_minibatch_counts_match_unique_oracle_and_reference():
    params = {"n_nodes": 20000, "n_edges": 120000, "seed": 5}
    g = csr_from_trace(resolve_trace_dataset("power_law", params))
    jg = jsampler.csr_from_trace(j_resolve("power_law", params))
    assert np.array_equal(g.ptr, jg.ptr) and np.array_equal(g.col, jg.col)
    kw = dict(batch_nodes=256, fanout=(10, 5), n_batches=6, seed=2)
    sched = minibatch_schedule(g, **kw)
    oracle = minibatch_oracle_counts(g, **kw)
    ref = jsampler.minibatch_schedule(jg, **kw)
    assert sched.n_tiles == kw["n_batches"]
    for f in ("edge_counts", "halo_counts", "remote_edge_counts"):
        assert np.array_equal(getattr(sched, f), oracle[f]), f
        assert np.array_equal(getattr(sched, f), getattr(ref, f)), f
    assert np.all(sched.halo_counts <= sched.remote_edge_counts)
    assert np.all(sched.vertex_counts == kw["batch_nodes"])
    assert minibatch_schedule(g, **kw) is sched
    assert np.array_equal(sched.cache_hit_fraction(0.1),
                          ref.cache_hit_fraction(0.1))


def test_csr_senders_of_a_factorization_only_trace():
    tr = resolve_trace_dataset("power_law", MB_PARAMS)
    _, _, _, mp = tr._pair_factorization()
    u_snd, u_rcv = tr._pair_factorization()[:2]
    free = GraphTrace.from_factorization(tr.n_nodes, u_snd, u_rcv, mp)
    assert np.array_equal(free.csr_senders, tr.csr_senders)
    assert np.array_equal(tr.csr_senders,
                          j_resolve("power_law", MB_PARAMS).csr_senders)


def test_minibatch_scenario_charges_episode_schedule():
    s = Scenario.minibatch("engn", dataset="power_law", params=MB_PARAMS,
                           N=30.0, T=16.0, **MB_KW)
    r = evaluate_scenarios([s], device="cpu").results[0]
    g = csr_from_trace(resolve_trace_dataset("power_law", MB_PARAMS))
    sched = minibatch_schedule(g, **MB_KW)
    assert r.meta["minibatch"]["sampled_edges"] == sched.n_edges
    assert r.meta["minibatch"]["gathered_sources"] == sched.halo_total
    ref = j_evaluate([JScenario.from_dict(s.to_dict())]).results[0]
    assert (r.total_bits, r.total_iterations) == (ref.total_bits,
                                                  ref.total_iterations)
    assert dict(r.breakdown) == dict(ref.breakdown)


@pytest.mark.parametrize("episode", range(4))
def test_episode_streams_equal_reference(episode):
    """The sampling protocol, draw for draw: one episode's seeds and
    sampled (sender, receiver) stream equal the reference's."""
    params = {"n_nodes": 1500, "n_edges": 9000, "seed": 7}
    g = csr_from_trace(resolve_trace_dataset("power_law", params))
    jg = jsampler.csr_from_trace(j_resolve("power_law", params))
    kw = dict(batch_nodes=40, fanout=(8, 4), episode=episode, seed=3)
    got = sampler_mod._episode_stream(g, **kw)
    want = jsampler._episode_stream(jg, **kw)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeds, snd, rcv = got
    assert np.unique(seeds).size == seeds.size == 40
    for s_, r_ in zip(snd[:64], rcv[:64]):
        assert s_ in g.col[g.ptr[r_]:g.ptr[r_ + 1]]


def test_build_csr_rejects_int32_overflow_boundary():
    snd = np.zeros(1, dtype=np.int64)
    rcv = np.zeros(1, dtype=np.int64)
    with pytest.raises(ValueError, match="int32") as exc:
        build_csr(snd, rcv, n_nodes=2**31)
    assert "int64" in str(exc.value)
    with pytest.raises(ValueError):
        build_csr(snd, np.array([3], dtype=np.int64), n_nodes=3)
    g = build_csr(np.array([0, 2, 2, 1]), np.array([1, 1, 0, 2]), n_nodes=3)
    assert g.n_nodes == 3 and g.col.dtype == np.int32
    assert int(g.ptr[-1]) == 4
    with pytest.raises(ValueError, match="batch_nodes"):
        minibatch_schedule(g, batch_nodes=4, fanout=(2,), n_batches=1)
    with pytest.raises(ValueError, match="fanout"):
        minibatch_schedule(g, batch_nodes=2, fanout=(0,), n_batches=1)


# ---------------------------------------------------------------------------
# Planner grouping and scenario round trips
# ---------------------------------------------------------------------------

def _hetero_scenario(df, tv, *, residency="spill", **kw):
    return Scenario.hetero(
        df, dataset="typed_blocks",
        params={k: v for k, v in TYPED_PARAMS.items()
                if k != "n_relations"},
        n_relations=TYPED_PARAMS["n_relations"],
        N=[30.0, 20.0, 10.0], T=16.0, tile_vertices=tv,
        widths=[[30.0, 20.0, 10.0], 16.0, 5.0], residency=residency, **kw)


def test_hetero_batch_one_group_per_dataflow_residency():
    scen = [_hetero_scenario(df, tv, residency=res)
            for df in ("engn", "hygcn")
            for res in ("spill", ["resident", "spill", "resident"])
            for tv in (64, 128)]
    res = evaluate_scenarios(scen, device="cpu")
    assert res.n_evaluations == 4
    for g in res.groups:
        assert len(g.indices) == 2
    ref = j_evaluate([JScenario.from_dict(s.to_dict()) for s in scen])
    for r, j in zip(res.results, ref.results, strict=True):
        assert np.isfinite(r.total_bits) and r.total_bits > 0
        assert r.meta["trace"] == j.meta["trace"]
        assert (r.total_bits, r.total_iterations) == (j.total_bits,
                                                      j.total_iterations)
        assert dict(r.breakdown) == dict(j.breakdown)


def test_hetero_group_matches_lone_evaluations():
    scen = [_hetero_scenario("engn", tv) for tv in (64, 128, 17)]
    batched = evaluate_scenarios(scen, device="cpu").results
    for s, br in zip(scen, batched):
        lone = evaluate_scenarios([s], device="cpu").results[0]
        assert lone.total_bits == br.total_bits
        assert lone.total_iterations == br.total_iterations


def test_hetero_and_minibatch_round_trip():
    h = _hetero_scenario("hygcn", 64,
                         residency=["resident", "spill", "resident"])
    m = Scenario.minibatch("engn", dataset="power_law", params=MB_PARAMS,
                           N=30.0, T=16.0, **MB_KW)
    for s in (h, m):
        s2 = Scenario.from_dict(s.to_dict())
        assert s2 == s and hash(s2) == hash(s)
        assert s2.plan_key() == s.plan_key()
        j = JScenario.from_dict(s.to_dict())
        assert j.to_json() == s.to_json()
        assert j.plan_key() == s.plan_key()
        assert Scenario.from_json(s.to_json()) == s
    assert h.graph_kind == "hetero" and m.graph_kind == "minibatch"


def test_hetero_and_minibatch_validation_rejections():
    with pytest.raises(ValueError, match="per-relation"):
        Scenario.hetero("engn", dataset="typed_blocks", params={},
                        n_relations=3, N=[1.0, 2.0], T=1.0,
                        tile_vertices=64, widths=[4.0, 4.0])
    with pytest.raises(ValueError, match="n_relations=3"):
        Scenario.hetero("engn", dataset="typed_blocks", params={},
                        n_relations=3, N=1.0, T=1.0, tile_vertices=64,
                        widths=[4.0, 4.0],
                        residency=["spill", "resident"])
    with pytest.raises(ValueError, match="only meaningful for a hetero"):
        Scenario.trace("engn", dataset="cora", N=1.0, T=1.0,
                       widths=[[4.0, 4.0], 4.0])
    with pytest.raises(ValueError, match="batch_nodes"):
        Scenario.minibatch("engn", dataset="power_law", params={},
                           batch_nodes=0, fanout=(5,), n_batches=2,
                           N=1.0, T=1.0)
    mb_graph = {"kind": "minibatch", "dataset": "power_law", "params": {},
                "batch_nodes": 4, "fanout": [5], "n_batches": 2,
                "seed": 0, "N": 1.0, "T": 1.0}
    with pytest.raises(ValueError, match="seed batch"):
        Scenario(dataflow="engn", graph=mb_graph,
                 composition=Composition(widths=(4.0, 4.0),
                                         tile_vertices=64.0))
    with pytest.raises(ValueError, match="minibatch"):
        Scenario(dataflow="engn", graph=mb_graph,
                 optimize={"objective": "movement"})
    with pytest.raises(ValueError, match="unknown graph kind"):
        Scenario(dataflow="engn", graph={"kind": "sharded"})
    with pytest.raises(ValueError, match="bad parameters"):
        evaluate_scenarios([Scenario.hetero(
            "engn", dataset="cora", n_relations=1, N=1.0, T=1.0,
            tile_vertices=64)], device="cpu")


# ---------------------------------------------------------------------------
# The tuner: per-relation residency search vs brute force
# ---------------------------------------------------------------------------
def test_tune_hetero_per_relation_residency_matches_brute_force():
    import itertools

    from repro.core.tune import tune_scenario as j_tune_scenario
    from repro_torch.core.tune import tune_scenario

    params = {"n_nodes": 200, "n_edges": 900, "seed": 3}
    base = Scenario.hetero(
        "engn", dataset="typed_blocks", params=params,
        n_relations=2, N=[30.0, 20.0], T=16.0, tile_vertices=64,
        widths=[[30.0, 20.0], 16.0, 5.0],
        optimize={"objective": "movement",
                  "space": {"dataflow": ["engn", "hygcn"],
                            "tile_vertices": [32, 64, 128],
                            "residency": ["spill", "resident"]}})
    res = tune_scenario(base, device="cpu")
    assert res.method == "exhaustive"
    assert res.n_candidates == 2 * (2 ** 2) * 3  # the residency axis is 2^R

    best = (np.inf, None)
    for df in ("engn", "hygcn"):
        for rr in itertools.product(("spill", "resident"), repeat=2):
            for tv in (32, 64, 128):
                s = Scenario.hetero(
                    df, dataset="typed_blocks", params=params,
                    n_relations=2, N=[30.0, 20.0], T=16.0,
                    tile_vertices=tv,
                    widths=[[30.0, 20.0], 16.0, 5.0], residency=list(rr))
                r = evaluate_scenarios([s], device="cpu").results[0]
                if r.total_bits < best[0]:
                    best = (r.total_bits, (df, float(tv), rr))
    assert res.best.total_bits == best[0]
    assert (res.best.dataflow, res.best.tile_vertices,
            res.best.residency) == best[1]
    # Per-relation residency serializes as a JSON list, not a tuple.
    d = res.best.to_dict()["residency"]
    assert isinstance(d, (str, list))
    # and the whole search record is the reference's
    ref = j_tune_scenario(JScenario.from_dict(base.to_dict()))
    assert res.to_dict() == ref.to_dict()


# ---------------------------------------------------------------------------
# COMPOSITION_FORMS: value parity with the array-path evaluations
# ---------------------------------------------------------------------------

def test_relational_halo_form_matches_model(typed_blocks):
    tr = typed_blocks
    cap = 64
    model = RelationalGraphModel("engn", tile_vertices=float(cap), trace=tr,
                                 device="cpu")
    full = FullGraphParams(V=tr.n_nodes, E=tr.n_edges, N=30.0, T=5.0)
    got = _terms_by_key(model.evaluate(full))
    hw = CompositionHardwareParams()
    form = dict(COMPOSITION_FORMS)["relationalhalo"]
    bits = iters = 0.0
    for r in range(tr.n_relations):
        sched = tr.relation(r).schedule(cap, device="cpu")
        g = RelationalScheduleParams(R=1, H=float(sched.halo_total),
                                     K=float(sched.K), W=30.0)
        b, i = form(g, hw)
        bits += float(b)
        iters += float(i)
    gb, gi = got[("haloreload", "L2-L1")]
    assert float(gb.reshape(-1)[0]) == bits
    assert float(gi.reshape(-1)[0]) == iters
    g4 = RelationalScheduleParams(R=4, H=100.0, K=256.0, W=32.0)
    assert form(g4, hw)[0] == 4 * form(g4.replace(R=1), hw)[0]


def test_relational_handoff_form_matches_model(typed_blocks):
    tr = typed_blocks
    cap = 64
    widths = (30.0, 16.0, 5.0)
    model = RelationalGraphModel("engn", tile_vertices=float(cap), trace=tr,
                                 widths=widths, residency="resident",
                                 device="cpu")
    full = FullGraphParams(V=tr.n_nodes, E=tr.n_edges, N=30.0, T=5.0)
    got = _terms_by_key(model.evaluate(full))
    hw = CompositionHardwareParams()
    form = dict(COMPOSITION_FORMS)["relationalhandoff"]
    sched0 = tr.relation(0).schedule(cap, device="cpu")
    bits = iters = 0.0
    for l in range(len(widths) - 2):
        for K_t in sched0.vertex_counts:
            g = RelationalScheduleParams(R=tr.n_relations, H=0.0,
                                         K=float(K_t),
                                         W=float(widths[l + 1]))
            b, i = form(g, hw)
            bits += float(b)
            iters += float(i)
    gb, gi = got[("residenthandoff", "L1-L1")]
    assert float(gb.reshape(-1)[0]) == bits
    assert float(gi.reshape(-1)[0]) == iters


def test_minibatch_gather_form_matches_episode_model():
    g = csr_from_trace(resolve_trace_dataset("power_law", MB_PARAMS))
    sched = minibatch_schedule(g, **MB_KW)
    model = TiledGraphModel("engn", schedule=sched)
    full = FullGraphParams(V=g.n_nodes, E=float(sched.n_edges),
                           N=30.0, T=16.0)
    got = _terms_by_key(model.evaluate(full))
    hw = CompositionHardwareParams()
    form = dict(COMPOSITION_FORMS)["minibatchgather"]
    gp = RelationalScheduleParams(R=1, H=float(sched.halo_total),
                                  K=float(MB_KW["batch_nodes"]), W=30.0)
    b, i = form(gp, hw)
    gb, gi = got[("haloreload", "L2-L1")]
    assert float(np.asarray(gb).reshape(-1)[0]) == float(b)
    assert float(np.asarray(gi).reshape(-1)[0]) == float(i)


# ---------------------------------------------------------------------------
# The front door: hetero_smoke.json and the rgcn_cora template
# ---------------------------------------------------------------------------

def test_hetero_smoke_holds_its_pins_through_the_cli(tmp_path):
    out = tmp_path / "hetero.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "--scenario",
         str(HETERO_SMOKE), "--device", "cpu", "--json", str(out)],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(out.read_text())
    assert [x["expect_ok"] for x in payload["results"]] == [True] * 4
    ref = j_evaluate([JScenario.from_dict(s.to_dict())
                      for s in load_scenarios(str(HETERO_SMOKE))])
    assert payload["results"] == json.loads(json.dumps(
        ref.to_dict()))["results"]
    smoke = _chip_smoke()
    assert tuple(x["total_bits"] for x in payload["results"]) == (
        smoke.HETERO_SMOKE_PINS)


def test_hetero_smoke_in_process_counts_no_launch_on_the_cpu(capsys):
    ttrace.clear_trace_cache()
    before = dict(ops.LAUNCHES)
    assert cli.main(["--scenario", str(HETERO_SMOKE), "--device",
                     "cpu"]) == 0
    assert "# 4 scenarios in 4 broadcast evaluations" in (
        capsys.readouterr().out)
    assert dict(ops.LAUNCHES) == before


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_rgcn_cora_grid_equals_reference_and_its_pin():
    port = evaluate_groups(template("rgcn_cora").scenarios, device="cpu")
    ref = j_evaluate_groups(j_template("rgcn_cora").scenarios)
    assert len(port) == len(ref) == len(registry.names())
    for p, j in zip(port, ref, strict=True):
        assert p.plan_key == j.plan_key and p.indices == j.indices
        assert p.output.names() == j.output.names()
        for t in p.output.terms:
            e = j.output[t.name]
            assert np.array_equal(t.data_bits, e.data_bits)
            assert np.array_equal(t.iterations, e.iterations)
    smoke = _chip_smoke()
    for groups in (port, ref):
        assert smoke.grid_digest(
            [(g.output, len(g.indices)) for g in groups]
        ) == smoke.RGCN_CORA_DIGEST


def test_rgcn_cora_with_capacities_and_resident_equals_reference():
    kw = dict(tile_vertices=np.array([256.0, 1024.0]),
              accelerators=("engn", "hygcn"), n_relations=2)
    port = evaluate_scenarios(template("rgcn_cora", **kw).scenarios,
                              device="cpu")
    ref = j_evaluate(j_template("rgcn_cora", **kw).scenarios)
    assert port.n_evaluations == ref.n_evaluations == 2
    assert port.rows() == ref.rows()


# ---------------------------------------------------------------------------
# The sampler's training half (twins of tests/test_hetero.py's sampler
# satellites), held bit for bit to the reference's.
# ---------------------------------------------------------------------------
_SUBGRAPH_FIELDS = ("node_ids", "senders", "receivers", "node_mask",
                    "edge_mask", "seed_mask")


def _csr_power_law(n_nodes=1500, n_edges=9000, seed=7):
    return csr_from_trace(resolve_trace_dataset(
        "power_law", {"n_nodes": n_nodes, "n_edges": n_edges,
                      "seed": seed}))


def _assert_same_subgraph(a, b, label) -> None:
    for f in _SUBGRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f, x.dtype, y.dtype)
        assert np.array_equal(x, y), (label, f)
    assert a.n_real_nodes == b.n_real_nodes
    assert a.n_real_edges == b.n_real_edges


def test_sample_subgraph_bit_matches_reference():
    g = _csr_power_law()
    for trial in range(5):
        seeds = np.random.default_rng(100 + trial).choice(
            g.n_nodes, size=40, replace=False)
        a = sampler_mod.sample_subgraph(g, seeds, (8, 4),
                                        rng=np.random.default_rng(trial),
                                        n_pad=4096, e_pad=8192)
        b = sampler_mod._sample_subgraph_reference(
            g, seeds, (8, 4), rng=np.random.default_rng(trial),
            n_pad=4096, e_pad=8192)
        _assert_same_subgraph(a, b, trial)


def test_sampled_subgraph_invariants():
    g = _csr_power_law()
    seeds = np.random.default_rng(0).choice(g.n_nodes, size=64,
                                            replace=False)
    sub = sampler_mod.sample_subgraph(g, seeds, (10, 5),
                                      rng=np.random.default_rng(1),
                                      n_pad=4096, e_pad=8192)
    for mask in (sub.node_mask, sub.edge_mask, sub.seed_mask):
        assert set(np.unique(mask)).issubset({0.0, 1.0})
    n_real, e_real = sub.n_real_nodes, sub.n_real_edges
    assert int(sub.node_mask.sum()) == n_real
    assert int(sub.edge_mask.sum()) == e_real
    assert np.all(sub.node_mask[n_real:] == 0.0)
    assert np.all(sub.edge_mask[e_real:] == 0.0)
    assert np.all(sub.seed_mask <= sub.node_mask)
    assert int(sub.seed_mask.sum()) == seeds.size
    assert np.array_equal(sub.node_ids[:seeds.size], seeds)
    real_ids = sub.node_ids[:n_real]
    assert np.unique(real_ids).size == n_real
    assert np.all((sub.senders[:e_real] >= 0)
                  & (sub.senders[:e_real] < n_real))
    assert np.all((sub.receivers[:e_real] >= 0)
                  & (sub.receivers[:e_real] < n_real))


def test_sample_subgraph_padding_overflow_raises():
    g = _csr_power_law()
    seeds = np.arange(40)
    for fn in (sampler_mod.sample_subgraph,
               sampler_mod._sample_subgraph_reference):
        with pytest.raises(ValueError, match="exceeds padding"):
            fn(g, seeds, (8, 4), rng=np.random.default_rng(0), n_pad=64,
               e_pad=64)



@settings(max_examples=25, deadline=None)
@given(n_nodes=st.integers(2, 300), density=st.integers(0, 8),
       seed=st.integers(0, 2**31 - 1),
       fanout=st.lists(st.integers(1, 6), min_size=0, max_size=3),
       n_seeds=st.integers(1, 16))
def test_sample_subgraph_bit_matches_the_reference_package(
        n_nodes, density, seed, fanout, n_seeds):
    """The port's ``sample_subgraph`` and ``_sample_subgraph_reference``
    against the reference's, every array and both counts, over drawn
    graphs (zero-degree nodes and empty fanouts included), seeds and
    fanouts, under the same ``rng``."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * density
    snd = rng.integers(0, n_nodes, n_edges)
    rcv = rng.integers(0, n_nodes, n_edges)
    g = build_csr(snd, rcv, n_nodes)
    jg = jsampler.build_csr(snd, rcv, n_nodes)
    seeds = rng.choice(n_nodes, size=min(n_seeds, n_nodes), replace=False)
    fanout = tuple(fanout)
    n_pad = e_pad = 1 << 14
    want = jsampler.sample_subgraph(jg, seeds, fanout,
                                    rng=np.random.default_rng(seed),
                                    n_pad=n_pad, e_pad=e_pad)
    for fn in (sampler_mod.sample_subgraph,
               sampler_mod._sample_subgraph_reference):
        got = fn(g, seeds, fanout, rng=np.random.default_rng(seed),
                 n_pad=n_pad, e_pad=e_pad)
        _assert_same_subgraph(got, want, fn.__name__)
    jref = jsampler._sample_subgraph_reference(
        jg, seeds, fanout, rng=np.random.default_rng(seed), n_pad=n_pad,
        e_pad=e_pad)
    _assert_same_subgraph(jref, want, "reference pin")
