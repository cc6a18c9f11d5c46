"""The dry run's EquiformerV2 cells on both production meshes, generated with
the CLI: the checks of ``tests/test_torch_dryrun_graph_recsys.py`` (the
twins of ``tests/test_dryrun_results.py``, see
``tests/torch_dryrun_records.py``) on a module fixture of their own.  Its
``ogb_products`` cell traces 64 edge chunks through 12 layers on each mesh,
the slowest of the dry run, so these cells trace on a worker of their own."""

import pytest

import torch_dryrun_records as dr

ARCHS = ["equiformer-v2"]
CELLS = dr.group_cells(ARCHS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return dr.run_cli(tmp_path_factory.mktemp("dryrun"), ARCHS)


@pytest.mark.parametrize("mesh", list(dr.MESHES))
def test_all_cells_present_and_ok(run, mesh):
    dr.check_present_and_ok(run, CELLS, mesh)


@pytest.mark.parametrize("mesh", list(dr.MESHES))
def test_memory_fits_per_device(run, mesh):
    dr.check_memory_fits(run, CELLS, mesh)


@pytest.mark.parametrize("mesh", list(dr.MESHES))
def test_roofline_inputs_recorded(run, mesh):
    dr.check_roofline_inputs(run, CELLS, mesh)


def test_multipod_shards_the_pod_axis(run):
    dr.check_multipod_shards(run, CELLS)


def test_gnn_ledger_is_the_traffic_model_at_world_256(run):
    dr.check_gnn_ledger(run, CELLS)


def test_gnn_records_name_the_even_edge_split(run):
    for rec in run["records"].values():
        assert "even split" in rec["notes"]["edge_layout"]
