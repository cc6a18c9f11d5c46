"""The reference's dry-run plans, for ``tests/test_torch_dryrun.py``.

``python tests/torch_dryrun_ref.py OUT.json`` builds the reference's
``launch.steps.build_cell`` for every run cell on both production meshes
(512 forced host devices, nothing lowered or compiled) and writes, per
``"<mesh>/<arch>/<shape>"``: the kind, ``model_flops``, ``meta`` (as
strings), each argument's leaves as ``[shape, dtype]`` in flatten order,
and one device's argument bytes (each leaf's
``NamedSharding.shard_shape``).
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402

from repro.configs import all_cells  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.launch.steps import build_cell  # noqa: E402


def describe(plan) -> dict:
    args = [[[list(x.shape), str(x.dtype)] for x in jax.tree_util.tree_leaves(a)]
            for a in plan.args]
    leaves = jax.tree_util.tree_leaves(plan.args)
    shardings = jax.tree_util.tree_flatten(
        plan.in_shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    total = 0
    for leaf, sh in zip(leaves, shardings):
        n = 1
        for d in sh.shard_shape(leaf.shape):
            n *= d
        total += n * leaf.dtype.itemsize
    return {"kind": plan.kind, "model_flops": plan.model_flops,
            "meta": {k: str(v) for k, v in plan.meta.items()},
            "args": args, "shard_bytes": total}


def main(out: str) -> None:
    result = {}
    for name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape, status in all_cells():
            if status == "run":
                result[f"{name}/{arch}/{shape}"] = describe(
                    build_cell(arch, shape, mesh))
    with open(out, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1])
