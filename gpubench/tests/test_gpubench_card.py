"""On the card: each cell's control (the reference in the program's place
in TF32, the precision below the configuration's float32) fails its
limits at the cell's own size.  Skips where no card is present."""

from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their size on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["gcn-products-fullbatch",
                                      "eqv2-reddit-512"])
def test_control_is_not_correct(cuda_device, workload):
    from gpubench import calibrate, check, harness

    cell = harness.load_cell(workload, CHECKOUT / "BENCHMARK.json")
    got = calibrate.readings(cell, 2 ** 31 + 5, "control", cuda_device)
    numbers = {k: (v, "") for k, v in got["numbers"].items()}
    assert not check.judge(numbers, cell["limits"]), got["numbers"]
