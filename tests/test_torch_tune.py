"""The port's design-space tuner against the JAX package's (the twin of
``tests/test_tune.py``, plus parity with the reference).

Every test of the reference's battery runs here against the port, on the
CPU (``device="cpu"``: trace candidates count their schedules with K4's
plain version): oracle parity with an independent brute force, the search
invariants, one factorization per multi-capacity tune, and the CLI's exit
codes.  The parity tests hold ``TuneResult.to_dict()`` equal to the
reference's, bit for bit, for ``tune_smoke.json``, ``tune_cora`` (open and
under a budget) and a trace tune of about 10^4 edges.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import Scenario as JScenario
from repro.api.templates import template as j_template
from repro.core.tune import tune_scenario as j_tune_scenario
from repro_torch.api import (Composition, Scenario, evaluate_scenario,
                             evaluate_scenarios, load_scenarios, template)
from repro_torch.api.cli import main as cli_main
from repro_torch.core import (InfeasibleBudgetError, clear_trace_cache,
                              registry, reset_trace_stats,
                              tile_working_set_bits, trace_cache_info,
                              tune_scenario)
from repro_torch.core.tune import normalize_optimize

ROOT = Path(__file__).resolve().parents[1]
TUNE_SMOKE = ROOT / "examples" / "scenarios" / "tune_smoke.json"
ALL_DATAFLOWS = registry.names()

# Tiny molecule-batch trace: a token-less dataset (no disk cache), so every
# cache observation below is about the in-process machinery only.
MOL = {"batch": 8, "n_nodes": 30, "n_edges": 64, "seed": 0, "step": 0}


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")


def tune(scenario):
    return tune_scenario(scenario, device="cpu")


def uniform_scenario(optimize, V=512, widths=(64, 16, 8), tile_vertices=128,
                     **kw):
    return Scenario.full_graph(
        ALL_DATAFLOWS[0], V=float(V), E=float(8 * V), N=float(widths[0]),
        T=float(widths[-1]), widths=widths, tile_vertices=tile_vertices,
        label="tune-uniform", optimize=optimize, **kw)


def trace_scenario(optimize, params=MOL, widths=(16, 16, 16),
                   tile_vertices=32, **kw):
    return Scenario.trace(
        ALL_DATAFLOWS[0], dataset="molecule", params=params,
        N=float(widths[0]), T=float(widths[-1]), widths=widths,
        tile_vertices=tile_vertices, label="tune-trace",
        optimize=optimize, **kw)


def oracle(scenario):
    """Independent brute force in the tuner's canonical enumeration: one
    planner call per candidate, feasibility from the same working-set
    closed form, the winner by masked ``np.argmin``."""
    opt = scenario.optimize
    space = opt["space"]
    comp = scenario.composition
    if scenario.graph_kind == "trace":
        from repro_torch.core import resolve_trace_dataset
        V = float(resolve_trace_dataset(scenario.graph["dataset"],
                                        scenario.graph["params"]).n_nodes)
    else:
        V = float(scenario.graph["V"])
    dataflows = space.get("dataflow")
    dataflows = (registry.names() if dataflows == "all"
                 else tuple(dataflows) if dataflows
                 else (scenario.dataflow,))
    residencies = tuple(space.get("residency") or (comp.residency,))
    halos = tuple(space.get("halo_dedup") or (comp.halo_dedup,))
    if "tile_vertices" in space:
        caps = tuple(space["tile_vertices"])
    elif "n_tiles" in space:
        caps = tuple(float(math.ceil(V / nt)) for nt in space["n_tiles"])
    else:
        caps = (float(comp.tile_vertices),)
    budget = opt["budget"]
    budget_bits = None if budget is None else budget["sram_bits"]

    cands, objs, srams = [], [], []
    for df in dataflows:
        sigma = float(scenario.hardware.get(
            "sigma", registry.get(df).hw_factory().sigma))
        for res in residencies:
            for hd in halos:
                for cap in caps:
                    c = scenario.replace(
                        dataflow=df, optimize=None, expect=None,
                        composition=Composition(
                            widths=comp.widths, residency=res,
                            tile_vertices=cap, halo_dedup=hd))
                    r = evaluate_scenario(c, device="cpu")
                    vals = {"movement": r.total_bits,
                            "offchip": r.offchip_bits,
                            "iterations": r.total_iterations}
                    obj = (float(vals[opt["objective"]])
                           if isinstance(opt["objective"], str) else
                           float(sum(w * vals[k]
                                     for k, w in opt["objective"].items())))
                    cands.append((df, cap, res, hd))
                    objs.append(obj)
                    srams.append(float(tile_working_set_bits(
                        cap, V=V, widths=comp.widths, sigma=sigma,
                        residency=res, halo_dedup=hd)))
    objs = np.asarray(objs)
    srams = np.asarray(srams)
    feas = (np.ones(len(cands), bool) if budget_bits is None
            else srams <= budget_bits)
    best = (None if not feas.any()
            else int(np.argmin(np.where(feas, objs, np.inf))))
    return cands, objs, srams, best


def assert_oracle_parity(scenario):
    cands, objs, srams, best = oracle(scenario)
    tr = tune(scenario)
    assert tr.method == "exhaustive"
    assert tr.n_candidates == tr.n_evaluated == len(cands)
    for i, (p, c) in enumerate(zip(tr.points, cands)):
        assert p.index == i
        assert (p.dataflow, p.tile_vertices, p.residency,
                p.halo_dedup) == (c[0], float(c[1]), c[2], float(c[3]))
        assert p.objective == objs[i]
        assert p.sram_bits == srams[i]
    assert tr.best.index == best
    assert tr.best.objective == objs[best]
    return tr


def assert_reference_parity(port_scenario):
    """The port's search record equals the reference's, bit for bit."""
    ref = j_tune_scenario(JScenario.from_dict(port_scenario.to_dict()))
    got = tune(port_scenario)
    assert got.to_dict() == ref.to_dict()
    return got


# ---------------------------------------------------------------------------
# 1. Oracle parity
# ---------------------------------------------------------------------------
def test_uniform_oracle_parity_all_dataflows_both_residencies():
    tr = assert_oracle_parity(uniform_scenario({
        "objective": "movement",
        "space": {"dataflow": "all",
                  "tile_vertices": [64, 128, 256, 512],
                  "residency": ["spill", "resident"]}}))
    assert tr.n_candidates == len(ALL_DATAFLOWS) * 2 * 4
    # capacities batch along the planner axis: one broadcast group per
    # (dataflow, residency) cell, never one per capacity
    assert tr.n_groups == len(ALL_DATAFLOWS) * 2


def test_trace_oracle_parity_all_dataflows_both_residencies():
    assert_oracle_parity(trace_scenario({
        "objective": "movement",
        "space": {"dataflow": "all",
                  "tile_vertices": [16, 32, 64],
                  "residency": ["spill", "resident"]}}))


@pytest.mark.parametrize("objective",
                         ["offchip", "iterations",
                          {"movement": 1.0, "iterations": 5e3}])
def test_oracle_parity_alternate_objectives(objective):
    assert_oracle_parity(uniform_scenario({
        "objective": objective,
        "space": {"dataflow": "all", "tile_vertices": [64, 256]}}))


def test_oracle_parity_halo_and_n_tiles_axes():
    assert_oracle_parity(uniform_scenario({
        "objective": "movement",
        "space": {"n_tiles": [1, 2, 4, 8],
                  "halo_dedup": [1.0, 2.0, 4.0]}}))


def test_oracle_parity_budgeted():
    tr = assert_oracle_parity(uniform_scenario({
        "objective": "movement",
        "budget": {"sram_bits": 6e4},
        "space": {"dataflow": "all",
                  "tile_vertices": [64, 128, 256, 512],
                  "residency": ["spill", "resident"]}}))
    assert tr.best.sram_bits <= 6e4
    assert tr.n_feasible < tr.n_candidates  # the budget actually bites


@settings(max_examples=10, deadline=None)
@given(st.integers(64, 2048), st.integers(2, 64), st.integers(1, 4),
       st.sampled_from(["movement", "offchip", "iterations"]))
def test_oracle_parity_hypothesis(V, w_hidden, n_caps, objective):
    caps = [2 ** (4 + i) for i in range(n_caps)]
    assert_oracle_parity(uniform_scenario(
        {"objective": objective,
         "space": {"dataflow": "all", "tile_vertices": caps,
                   "residency": ["spill", "resident"]}},
        V=V, widths=(32, w_hidden, 8)))


def test_coordinate_descent_matches_exhaustive_here():
    """On these small spaces the memoized coordinate descent lands on the
    oracle's winner."""
    opt = {"objective": "movement",
           "space": {"dataflow": "all",
                     "tile_vertices": [64, 128, 256, 512],
                     "residency": ["spill", "resident"]}}
    ex = tune(uniform_scenario(opt))
    co = tune(uniform_scenario({**opt, "method": "coordinate"}))
    assert co.method == "coordinate"
    assert co.n_evaluated < co.n_candidates or co.n_candidates <= 8
    assert co.best.objective == ex.best.objective
    assert (co.best.dataflow, co.best.tile_vertices, co.best.residency) == \
        (ex.best.dataflow, ex.best.tile_vertices, ex.best.residency)
    # and the descent's record is the reference's
    assert_reference_parity(uniform_scenario({**opt, "method": "coordinate"}))


def test_auto_method_switches_on_max_exhaustive():
    opt = {"objective": "movement",
           "space": {"tile_vertices": [64, 128, 256, 512]}}
    assert tune(uniform_scenario(opt)).method == "exhaustive"
    small = tune(uniform_scenario({**opt, "max_exhaustive": 2}))
    assert small.method == "coordinate"
    # capacity is the only multi-valued axis: one sweep of it is a complete
    # enumeration, so the descent path is oracle-exact too
    full = tune(uniform_scenario(opt))
    assert small.best.objective == full.best.objective
    assert small.best.index == full.best.index


# ---------------------------------------------------------------------------
# 2. Search invariants
# ---------------------------------------------------------------------------
def test_objective_monotone_as_budget_relaxes():
    space = {"dataflow": "all", "tile_vertices": [64, 128, 256, 512],
             "residency": ["spill", "resident"]}
    open_tr = tune(uniform_scenario({"objective": "movement",
                                     "space": space}))
    srams = sorted({p.sram_bits for p in open_tr.points})
    prev = math.inf
    for budget in srams:
        tr = tune(uniform_scenario({"objective": "movement", "space": space,
                                    "budget": {"sram_bits": budget}}))
        assert tr.best.sram_bits <= budget
        assert tr.best.objective <= prev
        prev = tr.best.objective
    assert prev == open_tr.best.objective


def test_pareto_frontier_is_nondominated_and_strictly_shaped():
    tr = tune(uniform_scenario({
        "objective": "movement",
        "space": {"dataflow": "all",
                  "tile_vertices": [64, 128, 256, 512],
                  "residency": ["spill", "resident"]}}))
    fr = tr.frontier
    assert fr, "an open-budget tune must produce a frontier"
    for a, b in zip(fr, fr[1:]):
        assert a.sram_bits < b.sram_bits
        assert a.objective > b.objective
    feas = [p for p in tr.points if p.feasible]
    for p in fr:
        for q in feas:
            assert not (q.sram_bits <= p.sram_bits
                        and q.objective < p.objective)
    assert fr[-1].objective == tr.best.objective


def test_one_point_space_returns_that_point():
    base = uniform_scenario(None)
    tr = tune(base.replace(optimize={
        "objective": "movement",
        "space": {"tile_vertices": [base.composition.tile_vertices]}}))
    assert tr.n_candidates == tr.n_evaluated == 1
    assert tr.best.index == 0
    assert tr.best.tile_vertices == base.composition.tile_vertices
    assert tr.best.dataflow == base.dataflow
    plain = evaluate_scenario(base)
    assert tr.best.objective == plain.total_bits
    assert tr.best_result.total_bits == plain.total_bits
    assert tr.frontier == tr.points


def test_budget_below_every_footprint_raises_typed_error():
    with pytest.raises(InfeasibleBudgetError, match="below every explored"):
        tune(uniform_scenario({
            "objective": "movement",
            "budget": {"sram_bits": 1.0},
            "space": {"dataflow": "all", "tile_vertices": [64, 128]}}))
    assert issubclass(InfeasibleBudgetError, ValueError)


def test_planner_routes_optimize_scenarios_and_orders_results():
    """A mixed batch: plain scenarios keep the broadcast path, optimize
    scenarios route through the tuner, results stay in input order."""
    plain = uniform_scenario(None)
    tuned = uniform_scenario({"objective": "movement",
                              "space": {"tile_vertices": [64, 128, 256]}})
    res = evaluate_scenarios([plain, tuned, plain], device="cpu")
    assert [r.scenario is s for r, s in
            zip(res.results, [plain, tuned, plain])] == [True] * 3
    assert res.results[0].total_bits == res.results[2].total_bits
    t = res.results[1].meta["tune"]
    assert t["best"]["objective"] == res.results[1].total_bits
    assert res.results[1].total_bits <= res.results[0].total_bits
    assert [g.indices for g in res.groups] == [(0, 2)]
    from repro_torch.api import evaluate_groups
    with pytest.raises(ValueError, match="evaluate_scenarios"):
        evaluate_groups([tuned])


def test_tune_expect_pins_gate_best_configuration():
    opt = {"objective": "movement",
           "space": {"dataflow": "all", "tile_vertices": [64, 128, 256]}}
    tr = tune(uniform_scenario(opt))
    good = uniform_scenario(opt, expect={
        "objective": tr.best.objective,
        "best_dataflow": tr.best.dataflow,
        "best_tile_vertices": tr.best.tile_vertices})
    bad = uniform_scenario(opt, expect={"best_dataflow": "no-such-dataflow"})
    res = evaluate_scenarios([good, bad], device="cpu")
    assert res.results[0].expect_ok is True
    assert res.results[1].expect_ok is False


def test_optimize_block_round_trips_and_extends_plan_key():
    s = uniform_scenario({"objective": "movement",
                          "space": {"tile_vertices": [64, 128]}})
    s2 = Scenario.from_dict(json.loads(json.dumps(s.to_dict())))
    assert s2 == s and hash(s2) == hash(s)
    assert s2.plan_key() == s.plan_key()
    assert s2.optimize == normalize_optimize(s2.optimize)  # idempotent
    plain = s.replace(optimize=None)
    assert plain.plan_key() != s.plan_key()
    # the serialized block is the reference's
    assert s.to_dict() == JScenario.from_dict(s.to_dict()).to_dict()


def test_optimize_schema_rejections():
    mk = uniform_scenario
    with pytest.raises(ValueError, match="unknown optimize space axis"):
        mk({"space": {"frobnicate": [1]}})
    with pytest.raises(ValueError, match="negative SRAM budget"):
        mk({"budget": {"sram_bits": -5}})
    with pytest.raises(ValueError, match="non-finite objective weight"):
        mk({"objective": {"movement": float("inf")}})
    with pytest.raises(ValueError, match="unknown objective"):
        mk({"objective": "latency"})
    with pytest.raises(ValueError, match="not both"):
        mk({"space": {"tile_vertices": [64], "n_tiles": [2]}})
    with pytest.raises(ValueError, match="exactly one"):
        mk({"budget": {"sram_bits": 1e6, "sram_bytes": 1e5}})
    with pytest.raises(ValueError, match="must not be empty"):
        mk({"space": {"tile_vertices": []}})
    with pytest.raises((ValueError, TypeError), match="optimize"):
        Scenario.tile(ALL_DATAFLOWS[0], optimize={"objective": "movement"})
    with pytest.raises(ValueError, match="mutually exclusive"):
        mk({"objective": "movement"}, conformance=True)
    with pytest.raises(ValueError, match="resident"):
        Scenario.trace(ALL_DATAFLOWS[0], dataset="molecule", params=MOL,
                       N=16.0, T=16.0, widths=None,
                       optimize={"space": {"residency": ["resident"]}})
    with pytest.raises(ValueError, match=r"halo_dedup must stay \[1\]"):
        trace_scenario({"space": {"halo_dedup": [1.0, 2.0]}})


# ---------------------------------------------------------------------------
# 3. Cache reuse: one factorization per dataset per tune run
# ---------------------------------------------------------------------------
def test_multi_capacity_trace_tune_is_one_factorization():
    params = {**MOL, "step": 7}  # fresh params: miss any earlier LRU entry
    clear_trace_cache()
    reset_trace_stats()
    tr = tune(trace_scenario({
        "objective": "movement",
        "space": {"dataflow": "all",
                  "tile_vertices": [8, 16, 32, 64, 128]}}, params=params))
    stats = trace_cache_info()["stats"]
    assert stats["trace_builds"] == 1
    assert stats["factorizations"] == 1
    assert tr.n_evaluated == len(ALL_DATAFLOWS) * 5
    assert stats["schedule_computes"] == 5
    assert stats["schedule_cache_hits"] >= (len(ALL_DATAFLOWS) - 1) * 5


def test_reset_trace_stats_zeroes_all_counters():
    reset_trace_stats()
    stats = trace_cache_info()["stats"]
    assert set(stats) == {"factorizations", "schedule_computes",
                          "schedule_cache_hits", "schedule_disk_hits",
                          "trace_builds"}
    assert all(v == 0 for v in stats.values())


def test_trace_tune_probes_raise_without_a_card(monkeypatch):
    """Every probe batch takes the caller's device: with the default (the
    card) and no card, a trace tune raises rather than run on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clear_trace_cache()
    s = trace_scenario({"space": {"tile_vertices": [16, 32]}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_scenario(s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_scenarios([s])
    assert tune_scenario(s, device="cpu").n_evaluated == 2


# ---------------------------------------------------------------------------
# 4. Parity with the reference's search records
# ---------------------------------------------------------------------------
def test_tune_smoke_records_match_reference():
    scenarios = load_scenarios(str(TUNE_SMOKE))
    assert len(scenarios) == 2
    for s in scenarios:
        assert_reference_parity(s)
    res = evaluate_scenarios(scenarios, device="cpu")
    assert not res.expect_failures()


@pytest.mark.parametrize("sram_bits", [None, 3e6], ids=["open", "budget"])
def test_tune_cora_records_match_reference(sram_bits):
    kw = {} if sram_bits is None else {"sram_bits": sram_bits}
    port, ref = template("tune_cora", **kw), j_template("tune_cora", **kw)
    assert [s.to_dict() for s in port.scenarios] == [
        s.to_dict() for s in ref.scenarios]
    got = assert_reference_parity(port.scenarios[0])
    if sram_bits is not None:
        assert got.best.sram_bits <= sram_bits
        assert got.n_feasible < got.n_candidates


def test_trace_tune_at_1e4_edges_matches_reference():
    clear_trace_cache()
    s = Scenario.trace(
        "engn", dataset="power_law_stream",
        params={"alpha": 1.6, "n_nodes": 1024.0, "n_edges": 10000.0,
                "seed": 0.0},
        N=64.0, T=16.0, widths=(64, 32, 16), tile_vertices=512.0,
        optimize={"objective": "movement",
                  "space": {"dataflow": "all",
                            "tile_vertices": [512.0, 256.0, 128.0, 64.0,
                                              32.0, 16.0, 8.0, 4.0]}})
    got = assert_reference_parity(s)
    assert got.n_candidates == 8 * len(ALL_DATAFLOWS)


# ---------------------------------------------------------------------------
# 5. CLI contract: exit codes and one-line errors
# ---------------------------------------------------------------------------
def _tune_batch(tmp_path, mutate=None, name="batch.json"):
    s = uniform_scenario({"objective": "movement",
                          "space": {"dataflow": "all",
                                    "tile_vertices": [64, 128, 256]}})
    batch = {"scenarios": [s.to_dict()]}
    if mutate is not None:
        mutate(batch)
    path = tmp_path / name
    path.write_text(json.dumps(batch))
    return str(path)


def test_cli_tune_happy_path_writes_json(tmp_path, capsys):
    out = tmp_path / "BENCH_tune.json"
    rc = cli_main(["--tune", _tune_batch(tmp_path), "--json", str(out),
                   "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 0
    assert "best_dataflow" in cap.out and "# frontier of" in cap.out
    payload = json.loads(out.read_text())
    assert payload["status"] == "ok"
    t = payload["results"][0]["tune"]
    assert t["method"] == "exhaustive"
    assert t["best"]["feasible"] is True
    assert len(t["points"]) == t["n_evaluated"]


@pytest.mark.parametrize("mutate,msg", [
    (lambda b: b["scenarios"][0]["optimize"]["space"].update(bogus=[1]),
     "unknown optimize space axis"),
    (lambda b: b["scenarios"][0]["optimize"].update(
        budget={"sram_bits": -1}), "negative SRAM budget"),
    (lambda b: b["scenarios"][0]["optimize"].update(
        objective={"movement": float("inf")}), "non-finite objective weight"),
    (lambda b: b["scenarios"][0].pop("optimize"), "no 'optimize' block"),
], ids=["unknown-axis", "negative-budget", "inf-weight", "plain-scenario"])
def test_cli_tune_schema_errors_exit_2(tmp_path, capsys, mutate, msg):
    rc = cli_main(["--tune", _tune_batch(tmp_path, mutate),
                   "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 2
    err_lines = [ln for ln in cap.err.splitlines() if ln.startswith("error:")]
    assert len(err_lines) == 1 and msg in err_lines[0]


def test_cli_tune_infeasible_budget_exits_2(tmp_path, capsys):
    path = _tune_batch(tmp_path, lambda b: b["scenarios"][0]["optimize"]
                       .update(budget={"sram_bits": 1}))
    rc = cli_main(["--tune", path, "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 2
    assert "below every explored configuration" in cap.err


def test_cli_tune_refuses_mode_mixing(tmp_path, capsys):
    rc = cli_main(["--tune", _tune_batch(tmp_path), "--template", "fig3",
                   "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 2
    assert "cannot be combined" in cap.err


def test_cli_tune_pin_drift_exits_1(tmp_path, capsys):
    path = _tune_batch(
        tmp_path, lambda b: b["scenarios"][0].update(
            expect={"best_dataflow": "no-such-dataflow"}))
    rc = cli_main(["--tune", path, "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 1
    assert "GOLDEN DRIFT" in cap.err


@pytest.mark.parametrize("argv,msg", [
    (["--scenario", "{tmp}/no-such-file.json"], "error:"),
    (["--scenario", "{tmp}/invalid.json"], "error:"),
    (["--scenario", "{tmp}/unknown-key.json"], "error:"),
    (["--scenario", "{tmp}/unknown-dataflow.json"], "error:"),
    (["--scenario", "{tmp}/bad-expect.json"], "error:"),
    ([], "no scenarios given"),
], ids=["missing-file", "invalid-json", "unknown-scenario-key",
        "unknown-dataflow", "bad-expect-key", "no-sources"])
def test_cli_scenario_error_paths_exit_2(tmp_path, capsys, argv, msg):
    (tmp_path / "invalid.json").write_text("{not json")
    tile = Scenario.tile(ALL_DATAFLOWS[0]).to_dict()
    (tmp_path / "unknown-key.json").write_text(
        json.dumps({"scenarios": [{**tile, "frobnicate": 1}]}))
    (tmp_path / "unknown-dataflow.json").write_text(
        json.dumps({"scenarios": [{**tile, "dataflow": "no-such"}]}))
    (tmp_path / "bad-expect.json").write_text(
        json.dumps({"scenarios": [{**tile, "expect": {"bogus_key": 1.0}}]}))
    rc = cli_main([a.format(tmp=tmp_path) for a in argv]
                  + ["--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 2
    assert msg in cap.err


def test_cli_scenario_pin_drift_exits_1(tmp_path, capsys):
    tile = Scenario.tile(ALL_DATAFLOWS[0]).to_dict()
    path = tmp_path / "drift.json"
    path.write_text(json.dumps(
        {"scenarios": [{**tile, "expect": {"total_bits": 123.0}}]}))
    rc = cli_main(["--scenario", str(path), "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 1
    assert "GOLDEN DRIFT" in cap.err


def test_cli_tune_smoke_holds_its_pins(capsys):
    assert cli_main(["--tune", str(TUNE_SMOKE), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tune-smoke-trace,tune-smoke,trace,awb_gcn,1024.0" in out
    assert "tune-smoke-cora,tune-smoke,full,awb_gcn,512.0" in out
