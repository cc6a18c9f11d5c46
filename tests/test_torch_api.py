"""The port's closed forms, composition layer and scenario front door
against the JAX package's.

Totals are float64 closed forms evaluated in the reference's operation
order, so they must be bit-identical (``assert_array_equal``); the trace
schedules behind them are counted by kernel K4's plain version on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Scenario as JScenario
from repro.api import evaluate_scenarios as j_evaluate
from repro.core import compose as jcompose
from repro.core import registry as jregistry
from repro.core import trace as jtrace
from repro.core.notation import paper_default_graph as j_paper_graph
from repro.core.validation import SEC4_GOLDEN_TOTALS
from repro_torch.api import Scenario, evaluate_scenarios, load_scenarios
from repro_torch.api import scenario as tscenario
from repro_torch.core import compose, registry
from repro_torch.core import trace as ttrace
from repro_torch.core.dataflow import SpecModel
from repro_torch.core.notation import paper_default_graph
from repro_torch.core.terms import tabulate

ROOT = Path(__file__).resolve().parents[1]
TRACE_SMOKE = ROOT / "examples" / "scenarios" / "trace_smoke.json"
DATAFLOWS = ("engn", "hygcn", "awb_gcn")
POWER_LAW = {"n_nodes": 2000, "n_edges": 12000, "seed": 0, "alpha": 1.6}
CAPS = [1000, 500, 250, 125, 62, 31]


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")


def _assert_same_output(got, expect):
    assert got.names() == expect.names()
    for t in got.terms:
        e = expect[t.name]
        assert t.hierarchy == e.hierarchy
        np.testing.assert_array_equal(t.data_bits, e.data_bits)
        np.testing.assert_array_equal(t.iterations, e.iterations)


# ---------------------------------------------------------------------------
# Closed forms: the port's copies are the reference's, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DATAFLOWS)
def test_closed_forms_match_reference_and_golden_totals(name):
    K = np.array([64.0, 1024.0, 5000.0, 1e6])
    got = registry.get(name).evaluate(paper_default_graph(K, N=130, T=16))
    expect = jregistry.get(name).evaluate(j_paper_graph(K, N=130, T=16))
    _assert_same_output(got, expect)
    out = registry.get(name).evaluate(paper_default_graph())
    assert (float(out.total_bits()), float(out.total_iterations())) == (
        SEC4_GOLDEN_TOTALS[name])


def test_spec_model_and_tabulate():
    out = SpecModel(registry.get("engn")).evaluate(paper_default_graph())
    assert out.accelerator == "engn"
    table = tabulate(out)
    assert "loadvertcache" in table and "L2*-L1" in table
    assert "<array sweep>" in tabulate(registry.get("hygcn").evaluate(
        paper_default_graph(np.array([64.0, 128.0]))))


@pytest.mark.parametrize("residency", ["spill", "resident"])
@pytest.mark.parametrize("name", DATAFLOWS)
def test_multi_layer_and_uniform_tiling_match_reference(name, residency):
    widths = (1433.0, 16.0, 7.0)
    tile = paper_default_graph(np.array([256.0, 2708.0]))
    got = compose.MultiLayerModel(name, widths, residency=residency)
    expect = jcompose.MultiLayerModel(name, widths, residency=residency)
    _assert_same_output(got.evaluate(tile), expect.evaluate(
        j_paper_graph(np.array([256.0, 2708.0]))))
    full = dict(V=2708.0, E=10556.0, N=1433.0, T=7.0)
    caps = np.array([128.0, 1000.0, 2708.0])
    _assert_same_output(
        compose.TiledGraphModel(got, tile_vertices=caps, halo_dedup=2.0
                                ).evaluate(compose.FullGraphParams(**full)),
        jcompose.TiledGraphModel(expect, tile_vertices=caps, halo_dedup=2.0
                                 ).evaluate(jcompose.FullGraphParams(**full)))
    np.testing.assert_array_equal(
        compose.tile_working_set_bits(caps, V=2708, widths=widths, sigma=4,
                                      residency=residency, halo_dedup=2.0),
        jcompose.tile_working_set_bits(caps, V=2708, widths=widths, sigma=4,
                                       residency=residency, halo_dedup=2.0))


# ---------------------------------------------------------------------------
# TiledGraphModel on an exact trace: scalar and capacity axis.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layers", ["one", "gcn_cora"])
@pytest.mark.parametrize("name", DATAFLOWS)
def test_trace_totals_match_reference(name, layers):
    port = ttrace.resolve_trace_dataset("power_law", POWER_LAW)
    ref = jtrace.resolve_trace_dataset("power_law", POWER_LAW)
    full = dict(V=float(port.n_nodes), E=float(port.n_edges), N=30.0,
                T=5.0)
    inner, j_inner = name, name
    if layers == "gcn_cora":
        inner = compose.MultiLayerModel(name, (1433.0, 16.0, 7.0))
        j_inner = jcompose.MultiLayerModel(name, (1433.0, 16.0, 7.0))
    for tv in (np.asarray(CAPS, np.float64), 512):
        got = compose.TiledGraphModel(inner, tile_vertices=tv, trace=port,
                                      device="cpu")
        expect = jcompose.TiledGraphModel(j_inner, tile_vertices=tv,
                                          trace=ref)
        out = got.evaluate(compose.FullGraphParams(**full))
        _assert_same_output(out, expect.evaluate(
            jcompose.FullGraphParams(**full)))
        np.testing.assert_array_equal(out.total_bits(), expect.evaluate(
            jcompose.FullGraphParams(**full)).total_bits())


def test_capacity_axis_rows_equal_scalar_runs():
    port = ttrace.resolve_trace_dataset("power_law", POWER_LAW)
    full = compose.FullGraphParams(V=2000.0, E=12000.0, N=30.0, T=5.0)
    multi = compose.TiledGraphModel("engn", tile_vertices=np.asarray(
        CAPS, np.float64), trace=port, device="cpu").evaluate(full)
    for b, cap in enumerate(CAPS):
        one = compose.TiledGraphModel("engn", tile_vertices=cap, trace=port,
                                      device="cpu").evaluate(full)
        assert multi.total_bits()[b] == one.total_bits()


def test_ring_of_tiles_anchor_trace_equals_uniform():
    """examples/trace_vs_analytical.py's anchor: on the uniform ring the
    exact trace and the uniform closed form agree bit for bit, in the port
    and in the reference alike."""
    ring = {"n_nodes": 1024.0, "n_tiles": 4.0}
    kw = dict(N=30.0, T=5.0, tile_vertices=256.0)
    t = evaluate_scenarios([Scenario.trace("engn", dataset="ring_of_tiles",
                                           params=ring, **kw)],
                           device="cpu").results[0]
    u = evaluate_scenarios([Scenario.full_graph("engn", V=1024.0, E=4096.0,
                                                **kw)]).results[0]
    j = j_evaluate([JScenario.trace("engn", dataset="ring_of_tiles",
                                    params=ring, **kw)]).results[0]
    assert t.total_bits == u.total_bits == j.total_bits
    assert t.breakdown == u.breakdown == j.breakdown
    assert t.n_tiles == u.n_tiles == 4.0


def test_trace_model_guards():
    port = ttrace.resolve_trace_dataset("ring_of_tiles",
                                        {"n_nodes": 64, "n_tiles": 4})
    with pytest.raises(ValueError, match="halo_dedup must be 1"):
        compose.TiledGraphModel("engn", trace=port, halo_dedup=2.0)
    with pytest.raises(ValueError, match="does not match the trace"):
        compose.TiledGraphModel("engn", tile_vertices=16, trace=port,
                                device="cpu").evaluate(
            compose.FullGraphParams(V=65.0, E=256.0, N=4.0, T=2.0))
    sched = port.schedule(16, device="cpu")
    out = compose.TiledGraphModel("hygcn", schedule=sched).evaluate(
        compose.FullGraphParams(V=64.0, E=256.0, N=4.0, T=2.0))
    assert out.meta["n_tiles"] == 4.0


# ---------------------------------------------------------------------------
# The scenario front door.
# ---------------------------------------------------------------------------
def test_trace_smoke_pins_through_the_cli():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "--scenario",
         str(TRACE_SMOKE), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for bits in ("5631360.0", "3763936.0", "898720.0"):
        assert bits in proc.stdout
    assert "GOLDEN DRIFT" not in proc.stderr


def test_cli_refuses_without_a_card_and_on_drift(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.api", "--scenario"]
    proc = subprocess.run(cmd + [str(TRACE_SMOKE)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    batch = json.loads(TRACE_SMOKE.read_text())
    batch["scenarios"][0]["expect"]["total_bits"] += 1.0
    path = tmp_path / "drift.json"
    path.write_text(json.dumps(batch))
    proc = subprocess.run(cmd + [str(path), "--device", "cpu"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1 and "GOLDEN DRIFT" in proc.stderr


def test_trace_smoke_matches_the_reference_planner():
    port = evaluate_scenarios(load_scenarios(str(TRACE_SMOKE)), device="cpu")
    from repro.api import load_scenarios as j_load
    ref = j_evaluate(j_load(str(TRACE_SMOKE)))
    assert not port.expect_failures()
    for got, expect in zip(port.results, ref.results):
        assert got.total_bits == expect.total_bits
        assert got.total_iterations == expect.total_iterations
        assert got.breakdown == expect.breakdown
        assert got.iteration_breakdown == expect.iteration_breakdown
        assert got.meta["trace"]["n_edges"] == 12000


def test_comparison_batch_matches_the_reference():
    """The reference's comparison batch, minus the dataflows and the
    conformance check the port does not carry, with its pins intact."""
    data = json.loads((ROOT / "examples/scenarios/comparison.json"
                       ).read_text())["scenarios"]
    keep = [d for d in data if d["dataflow"] in DATAFLOWS
            and not d.get("conformance")]
    assert len(keep) >= 4
    port = evaluate_scenarios([Scenario.from_dict(d) for d in keep])
    ref = j_evaluate([JScenario.from_dict(d) for d in keep])
    assert not port.expect_failures()
    assert port.n_evaluations == ref.n_evaluations
    for got, expect in zip(port.results, ref.results):
        assert got.scenario.graph_kind == expect.scenario.graph_kind
        assert got.total_bits == expect.total_bits
        assert got.breakdown == expect.breakdown
        assert got.n_tiles == expect.n_tiles


def test_capacity_sweep_is_one_group_and_round_trips():
    scen = [Scenario.trace("hygcn", dataset="power_law", params=POWER_LAW,
                           N=30.0, T=5.0, tile_vertices=float(c),
                           widths=(30.0, 8.0, 5.0), residency="resident",
                           hardware={"B": 800.0 + c})
            for c in CAPS]
    res = evaluate_scenarios(scen, device="cpu")
    assert res.n_evaluations == 1
    ref = j_evaluate([JScenario.from_dict(s.to_dict()) for s in scen])
    assert [r.total_bits for r in res.results] == [
        r.total_bits for r in ref.results]
    again = [Scenario.from_json(s.to_json()) for s in scen]
    assert again == scen and len(set(again)) == len(CAPS)


@pytest.mark.parametrize("feature", sorted(tscenario.NOT_PORTED))
def test_unported_features_name_their_roadmap_item(feature):
    base = {"dataflow": "engn", "graph": {"kind": "trace",
            "dataset": "cora", "N": 30.0, "T": 5.0},
            "composition": {"tile_vertices": 512.0}}
    if feature in ("hetero", "minibatch"):
        base["graph"]["kind"] = feature
    elif feature == "optimize":
        base["optimize"] = {"objective": "movement"}
    else:
        base["conformance"] = True
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item"):
        Scenario.from_dict(base)


def test_schema_rejections_match_reference():
    with pytest.raises(ValueError, match="needs a composition"):
        Scenario(dataflow="engn", graph={"kind": "trace", "dataset": "cora",
                                         "N": 1.0, "T": 1.0})
    with pytest.raises(ValueError, match="halo_dedup must stay 1"):
        Scenario.trace("engn", dataset="cora", N=1.0, T=1.0).replace(
            composition=tscenario.Composition(tile_vertices=8.0,
                                              halo_dedup=2.0))
    with pytest.raises(ValueError, match="full-graph scenario"):
        Scenario(dataflow="engn", graph={"V": 8.0, "E": 8.0, "N": 1.0,
                                         "T": 1.0})
    with pytest.raises(ValueError, match="unknown hardware override"):
        evaluate_scenarios([Scenario.tile("engn", hardware={"Bogus": 1.0})])
    with pytest.raises(KeyError, match="unknown port dataflow"):
        evaluate_scenarios([Scenario.tile("spmm_tiled")])


def test_evaluate_scenarios_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ttrace.clear_trace_cache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_scenarios(load_scenarios(str(TRACE_SMOKE)))
    # Tile and full scenarios never touch a device.
    assert evaluate_scenarios([Scenario.tile("engn")]).results[0].total_bits \
        == SEC4_GOLDEN_TOTALS["engn"][0]
