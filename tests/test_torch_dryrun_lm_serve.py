"""The dry run's LM serving cells (prefill and decode) on both production
meshes, generated with the CLI: the twins of
``tests/test_dryrun_results.py`` (see ``tests/torch_dryrun_records.py``)."""

import pytest

import torch_dryrun_records as dr

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b", "granite-3-2b", "gemma2-2b",
         "smollm-135m"]
SHAPES = ["prefill_32k", "decode_32k", "long_500k"]
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


def test_serving_params_shard_over_dp_where_the_reference_does(run):
    """FSDP serving (a tensor-parallel shard of the bf16 weights past 8e9
    B): arctic alone, its ledger gathering the blocks (tag ``"fsdp"``)."""
    for (mesh, arch, shape), rec in run["records"].items():
        fsdp = rec["collectives"]["by_tag"].get("fsdp")
        assert bool(fsdp) == (arch == "arctic-480b"), (mesh, arch, shape)
