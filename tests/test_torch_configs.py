"""The port's architecture registry and workload bridges against the JAX
reference's.

Every ``ArchDef`` is held to the reference's field by field (both configs
too), the cell grid likewise, and the bridges' scenarios and their
evaluated totals bit for bit (float64 closed forms in the reference's
order; trace schedules counted by K4's plain version on the CPU).  The
twins of the reference's bridge tests (``tests/test_api.py``,
``tests/test_trace.py``) keep their names, with ``device="cpu"``.  Also
here: the reference's public names that the port's ``api`` and ``core``
lacked, and the round trips that ``dump_scenarios`` unblocks.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro.core as jcore
from repro import configs as jconfigs
from repro.api import Scenario as JScenario
from repro.api import evaluate_groups as j_evaluate_groups
from repro.api import evaluate_scenarios as j_evaluate
from repro.api import load_scenarios as j_load_scenarios
import repro.core.spmm_tiled as jspmm_tiled
import repro.data.sampler as jsampler
import repro.models.common as jcommon
import repro_torch.api as tapi
import repro_torch.core as tcore
import repro_torch.core.spmm_tiled as tspmm_tiled
import repro_torch.data.sampler as tsampler
import repro_torch.models.common as tcommon
from repro_torch import configs
from repro_torch.api import (Scenario, dump_scenarios, evaluate_groups,
                             evaluate_scenario, evaluate_scenarios,
                             load_scenarios, scenarios_to_dicts, template)
from repro_torch.api.cli import main as cli_main
from repro_torch.core import registry
from repro_torch.core.trace import CORA_E, CORA_V, resolve_trace_dataset

ROOT = Path(__file__).resolve().parents[1]
ALL_DATAFLOWS = registry.names()
ARCHS = list(jconfigs.REGISTRY)
WORKLOADS = ("smollm-135m", "gemma2-2b", "equiformer-v2", "dlrm-mlperf")


@pytest.fixture(autouse=True)
def _no_disk_cache(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CACHE", "0")
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE", "0")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _config_fields(cfg) -> dict:
    """A config as plain data: dataclasses (an MoE block too) by field,
    the training knobs (``remat``, ``q_chunk``) among them."""
    return {f.name: (_config_fields(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


def _assert_same_results(got, expect):
    assert len(got.results) == len(expect.results)
    for r, e in zip(got.results, expect.results):
        assert r.scenario.to_dict() == e.scenario.to_dict()
        assert r.total_bits == e.total_bits
        assert r.total_iterations == e.total_iterations
        assert r.breakdown == e.breakdown
        assert r.iteration_breakdown == e.iteration_breakdown
        assert r.n_tiles == e.n_tiles
    assert got.n_evaluations == expect.n_evaluations


# ---------------------------------------------------------------------------
# The registry: every ArchDef, both configs, the cell grid.
# ---------------------------------------------------------------------------
def test_registry_order_matches_reference():
    assert list(configs.REGISTRY) == list(jconfigs.REGISTRY)
    assert [a.name for a in configs.all_archs()] == ARCHS
    assert sorted(configs.__all__) == sorted(jconfigs.__all__)


@pytest.mark.parametrize("name", ARCHS)
def test_archdef_matches_reference(name):
    arch, ref = configs.get_arch(name), jconfigs.get_arch(name)
    assert (arch.name, arch.family, arch.notes) == (ref.name, ref.family,
                                                    ref.notes)
    assert dict(arch.skips) == dict(ref.skips)
    assert list(arch.shapes) == list(ref.shapes)
    for sname, spec in arch.shapes.items():
        rspec = ref.shapes[sname]
        assert (spec.name, spec.kind, dict(spec.params)) == (
            rspec.name, rspec.kind, dict(rspec.params))
    assert arch.cells() == ref.cells()
    assert (arch.scenario_widths is None) == (ref.scenario_widths is None)
    for make in ("make_config", "make_smoke_config"):
        cfg, jcfg = getattr(arch, make)(), getattr(ref, make)()
        assert type(cfg).__name__ == type(jcfg).__name__
        assert _config_fields(cfg) == _config_fields(jcfg), make
        for attr in ("param_count", "active_param_count", "L2"):
            if hasattr(jcfg, attr):
                got, want = getattr(cfg, attr), getattr(jcfg, attr)
                assert (got() if callable(got) else got) == (
                    want() if callable(want) else want), attr


def test_all_cells_match_reference():
    for skipped in (False, True):
        assert configs.all_cells(include_skipped=skipped) == (
            jconfigs.all_cells(include_skipped=skipped))
    assert len(configs.all_cells(include_skipped=True)) == 40


def test_shape_families_match_reference():
    for family in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        port, ref = getattr(configs, family), getattr(jconfigs, family)
        assert list(port) == list(ref)
        for name, spec in port.items():
            assert (spec.name, spec.kind, dict(spec.params)) == (
                ref[name].name, ref[name].kind, dict(ref[name].params))


def test_equiformer_irrep_bookkeeping_matches_reference():
    cfg = configs.get_arch("equiformer-v2").make_config()
    jcfg = jconfigs.get_arch("equiformer-v2").make_config()
    assert cfg.L2 == jcfg.L2 == 49
    for l in range(cfg.l_max + 1):
        assert cfg.m_dim(l) == jcfg.m_dim(l)
    for m in range(cfg.m_max + 1):
        assert cfg.ls_for_m(m) == jcfg.ls_for_m(m)


def test_get_arch_unknown_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-5")


# ---------------------------------------------------------------------------
# The workload bridges: the reference's tests, twinned.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_name", WORKLOADS)
def test_workload_bridge_evaluates_across_all_dataflows(arch_name):
    arch = configs.get_arch(arch_name)
    scenarios = arch.to_scenarios()
    assert {s.dataflow for s in scenarios} == set(ALL_DATAFLOWS)
    res = evaluate_scenarios(scenarios, device="cpu")
    # one broadcast evaluation per dataflow: shapes batch within an arch.
    assert res.n_evaluations == len(ALL_DATAFLOWS)
    for r in res.results:
        assert np.isfinite(r.total_bits) and r.total_bits > 0
        assert np.isfinite(r.total_iterations) and r.total_iterations > 0
        assert r.scenario.workload.startswith(arch_name)
    _assert_same_results(res, j_evaluate(
        jconfigs.get_arch(arch_name).to_scenarios()))


def test_workload_bridge_tile_language_mappings():
    # gemma2: the 4k sliding window bounds the banded-graph neighborhood.
    (s,) = configs.get_arch("gemma2-2b").to_scenarios(
        shapes=("prefill_32k",), dataflows=("engn",))
    assert s.graph["K"] == 32768.0
    assert s.graph["P"] == 32768.0 * 4096.0
    assert s.composition.widths == (2304.0,) * 27
    # smollm: full causal attention -> W = seq.
    (s,) = configs.get_arch("smollm-135m").to_scenarios(
        shapes=("train_4k",), dataflows=("engn",))
    assert s.graph["P"] == 4096.0 * 4096.0
    # equiformer: irreps flatten to (l_max+1)^2 * C.
    (s,) = configs.get_arch("equiformer-v2").to_scenarios(
        shapes=("ogb_products",), dataflows=("engn",))
    assert s.composition.widths[1] == (6 + 1) ** 2 * 128
    assert s.graph["V"] == 2449029.0 and s.graph["E"] == 61859140.0
    # dlrm: embedding gather as aggregation.
    (s,) = configs.get_arch("dlrm-mlperf").to_scenarios(
        shapes=("serve_p99",), dataflows=("engn",))
    assert s.graph["K"] == 512.0
    assert s.graph["P"] == 512.0 * 26
    assert s.graph["N"] == 128.0 and s.graph["T"] == 1.0


def test_cli_template_and_workload_sources(tmp_path):
    out = tmp_path / "t.json"
    assert cli_main(["--template", "fig6", "--json", str(out),
                     "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["n_evaluations"] == 1
    assert cli_main(["--workload", "gcn-cora", "--shape", "molecule",
                     "--dataflows", "engn,awb_gcn", "--json", str(out),
                     "--device", "cpu"]) == 0
    payload = json.loads(out.read_text())
    assert payload["n_scenarios"] == 2
    assert payload["n_evaluations"] == 2
    ref = j_evaluate(jconfigs.get_arch("gcn-cora").to_scenarios(
        shapes=("molecule",), dataflows=("engn", "awb_gcn")))
    assert payload["results"] == ref.to_dict()["results"]


def test_workload_bridge_trace_kind():
    arch = configs.get_arch("gcn-cora")
    scens = arch.to_scenarios(shapes=("full_graph_sm", "molecule"),
                              dataflows=("engn",), graph_kind="trace")
    assert [s.graph["dataset"] for s in scens] == ["cora", "molecule"]
    res = evaluate_scenarios(scens, device="cpu")
    for r in res.results:
        assert np.isfinite(r.total_bits) and r.total_bits > 0
    with pytest.raises(ValueError, match="trace"):
        configs.get_arch("smollm-135m").to_scenarios(graph_kind="trace")
    with pytest.raises(ValueError, match="graph_kind"):
        arch.to_scenarios(graph_kind="bogus")
    _assert_same_results(res, j_evaluate(
        jconfigs.get_arch("gcn-cora").to_scenarios(
            shapes=("full_graph_sm", "molecule"), dataflows=("engn",),
            graph_kind="trace")))


def test_cora_trace_template_single_group_per_dataflow():
    tb = template("cora_trace")
    res = evaluate_scenarios(tb.scenarios, device="cpu")
    assert res.n_evaluations == len(ALL_DATAFLOWS)
    trace = resolve_trace_dataset("cora", {"seed": 0.0, "alpha": 1.6})
    assert (trace.n_nodes, trace.n_edges) == (CORA_V, CORA_E)
    # kept in sync with the Cora workload config's shape cell
    cell = configs.GNN_SHAPES["full_graph_sm"].params
    assert (cell["n_nodes"], cell["n_edges"]) == (CORA_V, CORA_E)


def test_cli_usage_errors(tmp_path, capsys):
    """The reference's test of the same name, with ``--device cpu``."""
    assert cli_main(["--device", "cpu"]) == 2
    # filters that only apply to --workload must not be silently dropped.
    assert cli_main(["--template", "fig6", "--dataflows", "engn",
                     "--device", "cpu"]) == 2
    assert cli_main(["--template", "fig6", "--shape", "train_4k",
                     "--device", "cpu"]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text('{"scenarios": [{"dataflow": "engn"}]}')
    assert cli_main(["--scenario", str(bad), "--device", "cpu"]) == 2
    assert cli_main(["--workload", "gpt-5", "--device", "cpu"]) == 2
    assert cli_main(["--workload", "gcn-cora", "--shape", "train_4k",
                     "--device", "cpu"]) == 2
    assert cli_main(["--list"]) == 0
    capsys.readouterr()


def test_cli_lists_the_workload_bridges(capsys):
    assert cli_main(["--list"]) == 0
    out = capsys.readouterr().out
    section = out[out.index("workload bridges (--workload NAME"):]
    for arch in jconfigs.all_archs():
        shapes = [s for s in arch.shapes if s not in arch.skips]
        assert f"{arch.name:20} [{arch.family}] shapes: {', '.join(shapes)}" \
            in section


def test_cli_workload_rows_match_the_reference(capsys):
    """``--workload gemma2-2b --workload dlrm-mlperf --device cpu`` prints
    the reference's rows."""
    from repro.api.cli import main as j_cli_main
    argv = ["--workload", "gemma2-2b", "--workload", "dlrm-mlperf"]
    assert cli_main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert j_cli_main(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert port[:-1] == ref[:-1] and len(port) == 1 + 4 * 5 + 4 * 5 + 1
    assert port[-1] == ref[-1] + " on cpu"


@pytest.mark.parametrize("kw", [{}, {"dataflows": ("engn", "hygcn")},
                                {"graph_kind": "hetero"}],
                         ids=["all", "two-dataflows", "hetero"])
def test_workload_scenarios_match_reference(kw):
    archs = (["gcn-cora", "meshgraphnet"] if "graph_kind" in kw else None)
    port = configs.workload_scenarios(archs, **kw)
    ref = jconfigs.workload_scenarios(archs, **kw)
    assert [s.to_dict() for s in port] == [s.to_dict() for s in ref]


def test_chip_smoke_bridge_digest_is_the_reference_grid():
    """chip_smoke.py holds the card's bridge grid to this pin; the pin is
    the reference's grid over all ten architectures, and the port's grid
    on the CPU gives it too."""
    smoke = _chip_smoke()
    ref = j_evaluate_groups(jconfigs.workload_scenarios())
    port = evaluate_groups(configs.workload_scenarios(), device="cpu")
    for groups in (ref, port):
        assert smoke.grid_digest(
            [(g.output, len(g.indices)) for g in groups]
        ) == smoke.BRIDGE_DIGEST
    assert len(port) == len(ref) == 50


# ---------------------------------------------------------------------------
# The reference's public names in the port.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("port,ref", [
    (tapi, japi), (tcore, jcore), (tspmm_tiled, jspmm_tiled),
    (tcommon, jcommon), (tsampler, jsampler)],
    ids=["api", "core", "spmm_tiled", "common", "sampler"])
def test_public_names_match_reference(port, ref):
    """Every name of the reference's ``__all__`` is in the port's (the
    port adds its own, such as the typed-trace kinds)."""
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert hasattr(port, name), name


def test_paper_defaults_and_model_classes_match_reference():
    for name in ("PAPER_DEFAULT_GRAPH", "PAPER_DEFAULT_ENGN",
                 "PAPER_DEFAULT_HYGCN"):
        got, want = getattr(tcore, name), getattr(jcore, name)
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            assert np.array_equal(getattr(got, f.name),
                                  getattr(want, f.name)), (name, f.name)
    for cls, dataflow in (("AWBGCNModel", "awb_gcn"),
                          ("TiledSpMMModel", "spmm_tiled"),
                          ("UnfusedSpMMModel", "spmm_unfused")):
        model = getattr(tcore, cls)()
        assert model.spec is registry.get(dataflow)
        got = model.evaluate(tcore.PAPER_DEFAULT_GRAPH)
        want = getattr(jcore, cls)().evaluate(jcore.PAPER_DEFAULT_GRAPH)
        assert got.names() == want.names()
        assert float(got.total_bits()) == float(want.total_bits())
        assert float(got.total_iterations()) == float(
            want.total_iterations())


# ---------------------------------------------------------------------------
# Round trips that dump_scenarios unblocks (reference tests/test_api.py,
# tests/test_trace.py).
# ---------------------------------------------------------------------------
def _policy_scenarios(dataflow: str) -> dict:
    """One scenario per structural shape the planner distinguishes."""
    return {
        "tile": Scenario.tile(dataflow, K=512.0),
        "tile_hw": Scenario.tile(dataflow, K=768.0, hardware={"B": 2000.0}),
        "ml_spill": Scenario.tile(
            dataflow, K=512.0, N=64.0, T=4.0,
            composition={"widths": [64, 16, 4], "residency": "spill"}),
        "ml_resident": Scenario.tile(
            dataflow, K=512.0, N=64.0, T=4.0,
            composition={"widths": [64, 16, 4], "residency": "resident"}),
        "tiled_spill": Scenario.full_graph(
            dataflow, V=2708.0, E=10556.0, N=1433.0, T=7.0,
            tile_vertices=512.0, widths=[1433, 16, 7], residency="spill"),
        "tiled_resident": Scenario.full_graph(
            dataflow, V=2708.0, E=10556.0, N=1433.0, T=7.0,
            tile_vertices=512.0, widths=[1433, 16, 7], residency="resident"),
    }


def test_scenario_file_round_trip(tmp_path):
    batch = [s for name in ALL_DATAFLOWS
             for s in _policy_scenarios(name).values()]
    path = tmp_path / "batch.json"
    dump_scenarios(batch, str(path))
    loaded = load_scenarios(str(path))
    assert loaded == batch
    # a bare JSON list loads too
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps([s.to_dict() for s in batch]))
    assert load_scenarios(str(bare)) == batch
    # the file is the reference's, byte for byte, and loads there
    jpath = tmp_path / "ref.json"
    japi.dump_scenarios([JScenario.from_dict(s.to_dict()) for s in batch],
                        str(jpath))
    assert path.read_text() == jpath.read_text()
    assert scenarios_to_dicts(batch) == japi.scenarios_to_dicts(
        j_load_scenarios(str(path)))


def test_trace_scenario_json_round_trip_bit_identical(tmp_path):
    scens = [
        Scenario.trace(df, dataset="power_law",
                       params={"n_nodes": 1500.0, "n_edges": 9000.0,
                               "seed": 0.0, "alpha": 1.7},
                       N=64.0, T=7.0, tile_vertices=512.0,
                       widths=(64.0, 16.0, 7.0), residency=res_)
        for df in ALL_DATAFLOWS for res_ in ("spill", "resident")
    ]
    for s in scens:
        s2 = Scenario.from_json(s.to_json())
        assert s2 == s and hash(s2) == hash(s)
        assert s2.plan_key() == s.plan_key()
        r1 = evaluate_scenario(s, device="cpu")
        r2 = evaluate_scenario(s2, device="cpu")
        assert r1.total_bits == r2.total_bits
        assert r1.breakdown == r2.breakdown
    path = tmp_path / "trace_batch.json"
    dump_scenarios(scens, str(path))
    assert load_scenarios(str(path)) == scens


def test_cli_comparison_batch(tmp_path, capsys):
    """The reference's test of the same name, with ``--device cpu``."""
    out = tmp_path / "BENCH_scenarios.json"
    scens = [s.replace(conformance=False)
             for s in load_scenarios("examples/scenarios/comparison.json")]
    batch_path = tmp_path / "comparison.json"
    dump_scenarios(scens, str(batch_path))
    rc = cli_main(["--scenario", str(batch_path), "--json", str(out),
                   "--device", "cpu"])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["status"] == "ok"
    assert payload["n_scenarios"] == len(scens)
    assert all(r.get("expect_ok", True) for r in payload["results"])
    assert "broadcast" in capsys.readouterr().out


def test_cli_exits_nonzero_on_golden_drift(tmp_path):
    drift = [Scenario.tile("engn", expect={"total_bits": 1.0})]
    path = tmp_path / "drift.json"
    dump_scenarios(drift, str(path))
    assert cli_main(["--scenario", str(path), "--device", "cpu"]) == 1
