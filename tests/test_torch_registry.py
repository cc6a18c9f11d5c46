"""The port's registry, figure sweeps and composition identities (the twin
of ``tests/test_registry.py``).

The port's closed forms are copies of the reference's float64 algebra, so
every golden, every figure grid and every flattened row must equal the JAX
reference's bit for bit; the composition layer obeys the same identities
(spill == L x single layer, tiled == n_tiles x per-tile + halo).  The
figure digests that ``chip_smoke.py`` holds the card's run to are pinned to
the reference here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.api import evaluate_groups as j_evaluate_groups
from repro.api import template as j_template
from repro.core import registry as jregistry
from repro.core import sweep as jsweep
from repro.core.notation import paper_default_graph as j_graph
from repro.core.validation import SEC4_GOLDEN_TOTALS as J_GOLDEN_TOTALS
from repro_torch.api import evaluate_groups, template, template_names
from repro_torch.core import (DataflowSpec, FullGraphParams, MultiLayerModel,
                              SpecModel, TiledGraphModel, paper_default_graph,
                              registry)
from repro_torch.core.sweep import (fig3_engn_movement, fig4_hygcn_movement,
                                    fig5_iterations_vs_bandwidth,
                                    fig6_fitting_factor, fig7_systolic_reuse,
                                    sweep_accelerators)
from repro_torch.core.validation import (SEC4_GOLDEN_TOTALS,
                                         crosscheck_registry,
                                         validate_dataflow_golden)

ROOT = Path(__file__).resolve().parents[1]
DATAFLOWS = ("engn", "hygcn", "spmm_tiled", "spmm_unfused", "awb_gcn")

# ---------------------------------------------------------------------------
# The reference's goldens at the paper's Sec. IV defaults: N=30, T=5,
# K=1024, L=102, P=10240, B=1000, sigma=4.  Exact float64 equality.
# ---------------------------------------------------------------------------
SEED_GOLDEN_TERMS = {
    "engn": [
        ("loadvertcache", "L2*-L1", 12240.0, 1.0),
        ("loadvertL2", "L2-L1", 122880.0, 8.0),
        ("loadedges", "L2-L1", 41000.0, 41.0),
        ("loadweights", "L2-L1", 600.0, 1.0),
        ("aggregate", "L1-L1", 2600960.0, 8.0),
        ("writecache", "L1-L2*", 2040.0, 1.0),
        ("writeL2", "L1-L2", 20480.0, 8.0),
    ],
    "hygcn": [
        ("loadvertL2", "L2-L1", 122880.0, 32.0),
        ("loadedges", "L2-L1", 41000.0, 41.0),
        ("loadweights", "L2-L1", 300.0, 1.0),
        ("aggregate", "L1-L1", 1228800.0, 4800.0),
        ("writeinterphase", "L1-L2", 123000.0, 123.0),
        ("combine", "L1-L1", 123480.0, 1.0),
        ("readinterphase", "L2-L1", 1229000.0, 1229.0),
        ("writeL2", "L1-L2", 21000.0, 21.0),
    ],
}

# Exact float64 sums of total_bits / total_iterations over each figure's
# default sweep grid (the reference's pins).
SEED_SWEEP_CHECKSUMS = {
    "fig3": (330498000.0, 194300.0),
    "fig4": (322443664.0, 1380406.0),
    "fig5a": (483692394.48517907, 106190.0),
    "fig5b": (501306728.39831495, 3823358.0),
    "fig6": (31311440.0, 12255.0),
    "fig7": (2153181014.0, 4681241.0),
}

#: Each figure: the port's sweep function and the reference's.
FIGURES = {
    "fig3": (fig3_engn_movement, jsweep.fig3_engn_movement),
    "fig4": (fig4_hygcn_movement, jsweep.fig4_hygcn_movement),
    "fig5a": (lambda: fig5_iterations_vs_bandwidth("engn"),
              lambda: jsweep.fig5_iterations_vs_bandwidth("engn")),
    "fig5b": (lambda: fig5_iterations_vs_bandwidth("hygcn"),
              lambda: jsweep.fig5_iterations_vs_bandwidth("hygcn")),
    "fig6": (fig6_fitting_factor, jsweep.fig6_fitting_factor),
    "fig7": (fig7_systolic_reuse, jsweep.fig7_systolic_reuse),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["engn", "hygcn"])
def test_registry_bit_identical_to_seed_terms(name):
    out = registry.evaluate(name, paper_default_graph())
    got = [(t.name, t.hierarchy, float(t.data_bits), float(t.iterations))
           for t in out.terms]
    assert got == SEED_GOLDEN_TERMS[name]


@pytest.mark.parametrize("name", sorted(SEC4_GOLDEN_TOTALS))
def test_registry_matches_validation_golden(name):
    total, iters = SEC4_GOLDEN_TOTALS[name]
    out = registry.evaluate(name, paper_default_graph())
    assert float(out.total_bits()) == total
    assert float(out.total_iterations()) == iters
    assert validate_dataflow_golden(name).ratio == 1.0


def test_golden_totals_cover_every_registered_dataflow():
    assert set(SEC4_GOLDEN_TOTALS) == set(registry.names())
    assert SEC4_GOLDEN_TOTALS == J_GOLDEN_TOTALS


@pytest.mark.parametrize("name", DATAFLOWS)
def test_sec4_terms_bit_identical_to_the_reference(name):
    got = registry.evaluate(name, paper_default_graph())
    expect = jregistry.evaluate(name, j_graph())
    assert got.names() == expect.names()
    for t in got.terms:
        e = expect[t.name]
        assert t.hierarchy == e.hierarchy
        for a, b in ((t.data_bits, e.data_bits), (t.iterations, e.iterations)):
            assert np.asarray(a).dtype == np.asarray(b).dtype == np.float64
            assert np.array_equal(a, b), (name, t.name)


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_sweep_grids_bit_identical_to_seed(fig):
    res = FIGURES[fig][0]()
    shape = tuple(len(v) for v in res.axes.values())
    bits = float(np.broadcast_to(res.total_bits, shape).sum())
    iters = float(np.broadcast_to(res.total_iterations, shape).sum())
    assert (bits, iters) == SEED_SWEEP_CHECKSUMS[fig]


@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_figure_grids_bit_identical_to_the_reference(fig):
    """Every term array of every figure, and the rows() flattening."""
    port, ref = FIGURES[fig]
    got, expect = port(), ref()
    assert got.figure == expect.figure
    assert list(got.axes) == list(expect.axes)
    for k in got.axes:
        assert np.array_equal(got.axes[k], expect.axes[k])
    for key in ("data_bits", "iterations"):
        a, b = getattr(got, key), getattr(expect, key)
        assert list(a) == list(b)
        for term in a:
            assert a[term].dtype == b[term].dtype == np.float64
            assert a[term].shape == b[term].shape
            assert np.array_equal(a[term], b[term]), (key, term)
    assert got.rows() == expect.rows()


def test_comparison_and_sweep_bit_identical_to_the_reference():
    sw, ref = sweep_accelerators(), jsweep.sweep_accelerators()
    assert sw.accelerators == ref.accelerators == DATAFLOWS
    for a, b in ((sw.total_bits, ref.total_bits),
                 (sw.total_iterations, ref.total_iterations),
                 *((sw.class_bits[c], ref.class_bits[c])
                   for c in ref.class_bits)):
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)
    assert sw.rows() == ref.rows()
    got = evaluate_groups(template("comparison").scenarios)
    expect = j_evaluate_groups(j_template("comparison").scenarios)
    assert [g.dataflow for g in got] == [g.dataflow for g in expect]
    for g, e in zip(got, expect):
        assert g.indices == e.indices
        for t in g.output.terms:
            for a, b in ((t.data_bits, e.output[t.name].data_bits),
                         (t.iterations, e.output[t.name].iterations)):
                assert a.dtype == np.asarray(b).dtype == np.float64
                assert np.array_equal(a, b)


def test_chip_smoke_figure_digests_are_the_reference_grids():
    """chip_smoke.py holds the card's figures to these pins; the pins are
    the reference's grids, and the port's grids on the CPU give them too."""
    smoke = _chip_smoke()
    names = [n for n in smoke.FIGURE_DIGESTS if n != "sweep_accelerators"]
    assert names == [n for n in template_names()
                     if n not in ("rgcn_cora", "tune_cora")]
    for name in names:
        ref = j_evaluate_groups(j_template(name).scenarios)
        port = evaluate_groups(template(name).scenarios, device="cpu")
        for groups in (ref, port):
            assert smoke.grid_digest(
                [(g.output, len(g.indices)) for g in groups]
            ) == smoke.FIGURE_DIGESTS[name], name
    for sw in (jsweep.sweep_accelerators(), sweep_accelerators()):
        assert smoke.grid_digest(
            [(o, sw.total_bits[0].size) for o in sw.meta["outputs"]]
        ) == smoke.FIGURE_DIGESTS["sweep_accelerators"]


# ---------------------------------------------------------------------------
# Registry surface.
# ---------------------------------------------------------------------------
def test_registry_has_all_builtin_accelerators():
    for name in DATAFLOWS:
        spec = registry.get(name)
        assert isinstance(spec, DataflowSpec)
        assert spec.name == name
        out = spec.evaluate(paper_default_graph())
        assert np.all(np.isfinite(out.total_bits()))
        assert float(out.total_bits()) > 0


def test_registry_unknown_name_lists_available():
    with pytest.raises(KeyError, match="engn"):
        registry.get("nonexistent")


def test_registry_rejects_duplicate_registration():
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("engn"))


def test_registry_temporarily_registered_restores():
    spec = DataflowSpec(name="scratch", movements=registry.get(
        "engn").movements, hw_factory=registry.get("engn").hw_factory)
    with registry.temporarily_registered(spec):
        assert registry.names()[-1] == "scratch"
        assert registry.evaluate("scratch", paper_default_graph()
                                 ).total_bits() == SEC4_GOLDEN_TOTALS["engn"][0]
    assert "scratch" not in registry.names()
    with pytest.raises(KeyError, match="cannot unregister"):
        registry.unregister("scratch")


def test_registry_model_adapter():
    m = registry.model("awb_gcn")
    assert isinstance(m, SpecModel)
    out = m.evaluate(paper_default_graph())
    assert out.accelerator == "awb_gcn"


def test_crosscheck_registry_passes():
    records = crosscheck_registry()
    assert set(records) == set(registry.names())
    for name, rec in records.items():
        if rec is not None:
            assert rec.ratio == 1.0, (name, rec)


def test_crosscheck_registry_conformance_on_cpu():
    records = crosscheck_registry(conformance=True, device="cpu")
    for name in registry.runnable_names():
        rec = records[f"{name}::conformance"]
        assert rec.analytical_bytes == rec.measured_bytes > 0
    audited = crosscheck_registry(analysis=True)
    for name in registry.names():
        assert audited[f"{name}::analysis"].ok, name


def test_spmm_tiled_block_sizes_match_kernel():
    """The port's spmm_tiled keeps the reference kernel's default blocks;
    the kernel spec's blocks come from each operating point."""
    from repro.kernels.edge_aggregate import DEFAULT_BLOCK_K, DEFAULT_BLOCK_N
    default = registry.get("spmm_tiled").hw_factory()
    assert (default.Bn, default.Bk) == (DEFAULT_BLOCK_N, DEFAULT_BLOCK_K)
    assert registry.get("spmm_tiled_cta").hw_factory() == default


# ---------------------------------------------------------------------------
# Composition layer: multi-layer.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DATAFLOWS)
@pytest.mark.parametrize("n_layers", [1, 2, 4])
def test_multilayer_spill_equals_L_times_single_layer(name, n_layers):
    w = 30
    graph = paper_default_graph().replace(N=w, T=w)
    single = registry.evaluate(name, graph)
    out = MultiLayerModel(name, [w] * (n_layers + 1),
                          residency="spill").evaluate(graph)
    assert float(out.total_bits()) == n_layers * float(single.total_bits())
    assert float(out.total_iterations()) == n_layers * float(
        single.total_iterations())
    for t in single.terms:
        assert float(out[t.name].data_bits) == n_layers * float(t.data_bits)


@pytest.mark.parametrize("name", DATAFLOWS)
def test_multilayer_resident_saves_offchip(name):
    graph = paper_default_graph().replace(T=30)
    widths = [30, 30, 30]
    spill = MultiLayerModel(name, widths, residency="spill").evaluate(graph)
    resident = MultiLayerModel(name, widths,
                               residency="resident").evaluate(graph)
    offchip_saved = float(spill.offchip_bits() + spill.cache_bits()
                          - resident.offchip_bits() - resident.cache_bits())
    assert offchip_saved > 0
    assert float(resident["residenthandoff"].data_bits) > 0
    assert resident["residenthandoff"].hierarchy == "L1-L1"


def test_multilayer_width_propagation():
    graph = paper_default_graph()
    out = MultiLayerModel("hygcn", [64, 16, 4]).evaluate(graph)
    l0 = registry.evaluate("hygcn", graph.replace(N=64, T=16))
    l1 = registry.evaluate("hygcn", graph.replace(N=16, T=4))
    assert float(out.total_bits()) == float(l0.total_bits()) + float(
        l1.total_bits())


def test_multilayer_rejects_bad_args():
    with pytest.raises(ValueError, match="widths"):
        MultiLayerModel("engn", [30])
    with pytest.raises(ValueError, match="residency"):
        MultiLayerModel("engn", [30, 5], residency="sometimes")


# ---------------------------------------------------------------------------
# Composition layer: tiled full graph.
# ---------------------------------------------------------------------------
def test_tiled_graph_is_ntiles_times_tile_plus_halo():
    full = FullGraphParams(V=4096, E=40960, N=30, T=5)
    model = TiledGraphModel("engn", tile_vertices=1024)
    out = model.evaluate(full)
    n_tiles, tile = model.tile_schedule(full)
    assert float(n_tiles) == 4.0
    per_tile = registry.evaluate("engn", tile)
    for t in per_tile.terms:
        assert float(out[t.name].data_bits) == 4.0 * float(t.data_bits)
    halo = out["haloreload"]
    assert halo.hierarchy == "L2-L1"
    assert float(halo.data_bits) == 40960 * 0.75 * 30 * 4


def test_tiled_graph_single_tile_has_no_halo():
    full = FullGraphParams(V=512, E=5120, N=30, T=5)
    out = TiledGraphModel("hygcn", tile_vertices=1024).evaluate(full)
    assert float(out["haloreload"].data_bits) == 0.0


def test_tiled_multilayer_composition_vectorized():
    caps = np.array([256.0, 512.0, 1024.0, 2048.0])
    cora = FullGraphParams(V=2708, E=10556, N=1433, T=7)
    for name in registry.names():
        out = TiledGraphModel(MultiLayerModel(name, [1433, 16, 7]),
                              tile_vertices=caps).evaluate(cora)
        arr = np.broadcast_to(out.total_bits(), caps.shape)
        assert np.all(np.isfinite(arr)) and np.all(arr > 0)
        halo = np.broadcast_to(out["haloreload"].data_bits, caps.shape)
        n_tiles = np.broadcast_to(out.meta["n_tiles"], caps.shape)
        expect = 10556 * (1.0 - 1.0 / n_tiles) * (1433 + 16) * 4
        np.testing.assert_allclose(halo, expect, rtol=0, atol=0)


def test_tiled_graph_halo_dedup_divides():
    full = FullGraphParams(V=4096, E=40960, N=30, T=5)
    plain = TiledGraphModel("engn", tile_vertices=1024).evaluate(full)
    dedup = TiledGraphModel("engn", tile_vertices=1024,
                            halo_dedup=2.0).evaluate(full)
    assert float(dedup["haloreload"].data_bits) == 0.5 * float(
        plain["haloreload"].data_bits)
    with pytest.raises(ValueError, match="halo_dedup"):
        TiledGraphModel("engn", halo_dedup=0.5)


# ---------------------------------------------------------------------------
# Vectorized all-accelerator sweep.
# ---------------------------------------------------------------------------
def test_sweep_accelerators_stacks_all_registered():
    sw = sweep_accelerators()
    A = len(registry.names())
    assert sw.accelerators == registry.names() and A == 5
    K = sw.axes["K"]
    assert sw.total_bits.shape == sw.total_iterations.shape == (A, len(K))
    for cls in ("offchip", "cache", "onchip"):
        assert sw.class_bits[cls].shape == (A, len(K))
    assert sw.meta["n_evaluations"] == A
    for name in ("engn", "hygcn"):
        direct = registry.evaluate(name, paper_default_graph(K))
        np.testing.assert_array_equal(sw.total_bits[sw.accelerator_index(
            name)], direct.total_bits())


def test_sweep_accelerators_rows_flatten():
    sw = sweep_accelerators(("engn", "hygcn"), K=np.array([256.0, 1024.0]))
    rows = sw.rows()
    assert len(rows) == 4
    assert {r["accelerator"] for r in rows} == {"engn", "hygcn"}
    for r in rows:
        assert set(r) == {"accelerator", "K", "total_bits",
                          "total_iterations", "bits_offchip", "bits_cache",
                          "bits_onchip"}
        assert isinstance(r["total_bits"], float)
    assert rows == jsweep.sweep_accelerators(
        ("engn", "hygcn"), K=np.array([256.0, 1024.0])).rows()


def test_sweep_rows_np_stack_flatten_matches_meshgrid_reference():
    """rows() reproduces a per-record meshgrid loop exactly."""
    res = fig3_engn_movement()
    names = list(res.axes)
    grids = np.meshgrid(*[res.axes[n] for n in names], indexing="ij")
    expected = []
    total_b = np.broadcast_to(res.total_bits, grids[0].shape)
    total_i = np.broadcast_to(res.total_iterations, grids[0].shape)
    for idx in np.ndindex(grids[0].shape):
        rec = {n: float(g[idx]) for n, g in zip(names, grids)}
        rec["total_bits"] = float(total_b[idx])
        rec["total_iterations"] = float(total_i[idx])
        for term, arr in res.data_bits.items():
            rec[f"bits_{term}"] = float(np.broadcast_to(arr,
                                                        grids[0].shape)[idx])
        expected.append(rec)
    assert res.rows() == expected


def test_spmm_tiled_block_sizes_match_kernel():
    """The analytical baseline models K1's tiling (twin of
    ``tests/test_registry.py::test_spmm_tiled_block_sizes_match_kernel``):
    ``kernel_matched_hw`` reads the kernel module's block sizes, and
    ``spmm_tiled``'s default hardware has the same; overrides win."""
    from repro.core.spmm_tiled import kernel_matched_hw as j_kernel_matched_hw
    from repro_torch.core import registry as tregistry
    from repro_torch.core.spmm_tiled import kernel_matched_hw
    from repro_torch.kernels.edge_aggregate import (DEFAULT_BLOCK_K,
                                                    DEFAULT_BLOCK_N)
    hw = kernel_matched_hw()
    assert (hw.Bn, hw.Bk) == (DEFAULT_BLOCK_N, DEFAULT_BLOCK_K)
    default = tregistry.get("spmm_tiled").hw_factory()
    assert (default.Bn, default.Bk) == (DEFAULT_BLOCK_N, DEFAULT_BLOCK_K)
    want = j_kernel_matched_hw()
    for name in ("Bn", "Bk"):
        assert getattr(hw, name) == getattr(want, name)
    assert kernel_matched_hw(Bn=128).Bn == 128
