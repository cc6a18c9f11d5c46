"""The dry run's LM train cells on both production meshes, generated with
the CLI: the twins of ``tests/test_dryrun_results.py`` (see
``tests/torch_dryrun_records.py``)."""

import pytest

import torch_dryrun_records as dr

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b", "granite-3-2b", "gemma2-2b",
         "smollm-135m"]
SHAPES = ["train_4k"]
CELLS = dr.group_cells(ARCHS, SHAPES)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return dr.run_cli(tmp_path_factory.mktemp("dryrun"), ARCHS, SHAPES)


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
