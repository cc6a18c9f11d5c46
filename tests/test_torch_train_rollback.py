"""``launch.train``'s runs on the CPU with a failure and a rollback: the loss
falls over 12 steps, and a run that fails at step 6 rolls back to its step-4
checkpoint and replays steps 4-11 exactly as the clean run took them.

These runs are the slowest of the training tests (SmolLM-135M at its
published widths most of it), so they sit in a file of their own and run on
a worker of their own under ``--dist loadfile``."""

import pytest

from repro_torch.launch import train


def _run(tmp_path, name, *argv):
    args = train.build_parser().parse_args(
        list(argv) + ["--device", "cpu", "--ckpt-dir", str(tmp_path / name)])
    return train.train(args)


@pytest.mark.parametrize("arch", ["smollm-135m", "gcn-cora", "dlrm-mlperf"])
def test_run_loss_falls_and_rollback_replays_exactly(tmp_path, arch):
    argv = ("--arch", arch, "--steps", "12", "--checkpoint-every", "4",
            "--lr", "1e-2")
    _, clean = _run(tmp_path, "clean", *argv)
    state, failed = _run(tmp_path, "failed", *argv, "--fail-at", "6")
    assert clean[-1]["loss"] < clean[0]["loss"]
    # Steps 4 and 5 run twice: before the failure and after the rollback.
    assert [h["step"] for h in failed] == list(range(6)) + list(range(4, 12))
    strip = lambda hist: [{k: v for k, v in h.items() if k != "dt"}
                          for h in hist]
    assert strip(failed[6:]) == strip(clean[4:])
    assert strip(failed[:6]) == strip(clean[:6])
    assert int(state[1].step) == 12
