"""The dry run's GNN and DLRM cells on both production meshes, generated
with the CLI: the twins of ``tests/test_dryrun_results.py`` (see
``tests/torch_dryrun_records.py``), and each GNN cell's ledger held to
``launch.steps.gnn_policy_traffic``."""

import pytest

import torch_dryrun_records as dr

ARCHS = ["gcn-cora", "equiformer-v2", "meshgraphnet", "gatedgcn",
         "dlrm-mlperf"]
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
    dr.check_gnn_ledger(run, [c for c in CELLS if c[0] != "dlrm-mlperf"])


def test_gnn_records_name_the_even_edge_split(run):
    for (mesh, arch, shape), rec in run["records"].items():
        if arch != "dlrm-mlperf":
            assert "even split" in rec["notes"]["edge_layout"]
