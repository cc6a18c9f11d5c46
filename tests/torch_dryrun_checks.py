"""The dry run's fake trace against a real run on the CPU, for
``tests/test_torch_dryrun.py``.

``python tests/torch_dryrun_checks.py OUT.json`` plans smoke-sized cells
on a (1, 1) mesh and counts each step's FLOPs twice: traced under
``FakeTensorMode`` inside a ``fake`` process group of one rank, then run
for real with seeded values (``CellPlan.step(draw=True)``) inside a
``gloo`` group of one rank under ``FlopCounterMode``.  It writes ``{case:
{"fake": flops, "real": flops, "fake_k5": ..., "real_k5": ...}}``."""

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_test_mesh


def _smoke(arch: str):
    cfg = get_arch(arch).make_smoke_config()
    if get_arch(arch).family == "lm" and cfg.d_head % 16:
        cfg = dataclasses.replace(cfg, d_head=16)   # a head dim K5 takes
    return cfg


#: case -> (arch, shape, the shape's parameters at smoke size, plan cuts)
CASES = {
    "granite-prefill": ("granite-3-2b", "prefill_32k",
                        {"seq": 64, "batch": 2}, {}),
    "qwen3-moe-prefill": ("qwen3-moe-30b-a3b", "prefill_32k",
                          {"seq": 32, "batch": 2}, {}),
    "smollm-train": ("smollm-135m", "train_4k", {"seq": 32, "batch": 2}, {}),
    "gemma2-decode": ("gemma2-2b", "decode_32k", {"seq": 64, "batch": 2},
                      {}),
    "dlrm-train": ("dlrm-mlperf", "train_batch", {"batch": 64}, {}),
    "dlrm-serve": ("dlrm-mlperf", "serve_bulk", {"batch": 64}, {}),
    "dlrm-retrieval": ("dlrm-mlperf", "retrieval_cand",
                       {"batch": 1, "n_candidates": 1000}, {}),
}


def _plans(policy) -> dict:
    out = {}
    for case, (arch, shape, p, cuts) in CASES.items():
        spec = get_arch(arch).shapes[shape]
        spec = dataclasses.replace(spec, params={**spec.params, **p})
        out[case] = steps.plan(arch, spec, policy, cfg=_smoke(arch), **cuts)
    return out


def main(path: str) -> None:
    k5 = torch.ops.repro_torch.flash_attention
    result = {case: {} for case in CASES}
    policy = dryrun.mesh_policy("card")
    for case, plan in _plans(policy).items():
        traced = plan.trace(torch.device("cpu"))
        result[case].update(fake=traced["flops"], fake_k5=traced["k5_flops"])
    dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{Path(tmp) / 'rv'}",
                                rank=0, world_size=1)
        policy = make_policy(make_test_mesh((1, 1), ("data", "model")))
        for case, plan in _plans(policy).items():
            fn, args = plan.step(torch.device("cpu"), draw=True, seed=0)
            counter = FlopCounterMode(display=False)
            with counter:
                fn(*args)
            result[case].update(
                real=float(counter.get_total_flops()),
                real_k5=float(counter.get_flop_counts().get(
                    "Global", {}).get(k5, 0)))
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1])
