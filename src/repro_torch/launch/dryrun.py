"""The dry run: every (arch x shape x mesh) cell traced as one rank of the
production meshes, with nothing allocated and nothing launched.

For each cell :func:`run_cell` builds the plan (``launch.steps.
build_cell``) and runs one rank's step under ``FakeTensorMode``
(``CellPlan.trace``) inside a ``fake`` process group of the mesh's size,
started in this process (:func:`start_fake_group`): a process group is
process-global, so the dry run runs in a process of its own.  It writes
one JSON record a cell to ``<out>/<mesh>/<arch>__<shape>.json`` with the
reference's keys where the port has a counterpart:

* ``kind``, ``model_flops``, ``meta``, ``ok`` (and ``error`` with the
  port's own message), ``trace_s``;
* ``memory``: ``state_bytes`` (the rank's blocks of the arguments, the
  reference's argument bytes, DLRM's zero rows included), ``arg_bytes``
  (what the traced step started from: indices widened to int64, and the
  global batch every rank of the port receives), ``peak_bytes`` and
  ``peak_by_op`` (the peak's bytes by the operation that made them);
* ``cost``: ``flops`` (``counters.FlopCounter``; ``k5_flops`` K5's share) and
  ``op_bytes`` (each operation's inputs read once and outputs written
  once: an unfused upper bound of HBM traffic, not XLA's
  ``bytes_accessed``);
* ``collectives``: the ledger's ``wire_bytes_per_chip``, by kind and by
  tag;
* ``roofline``: the H100 row (``core.gpu_model.roofline``).

XLA's ``bytes_accessed`` and the CPU-lowering ``bf16_arg_bytes`` have no
counterpart (``no_counterpart`` in the record says so).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--force] [--out DIR] [--jobs N]

``--mesh card`` traces a (1, 1) mesh (one card, the cells ``chip_smoke.py``
holds against real steps), where ``--batch``, ``--row-cap`` and
``--max-seq`` cut a cell.
It prints one line a cell and exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

__all__ = ["RESULTS_DIR", "MESHES", "KNOWN_FAILURES", "start_fake_group",
           "mesh_policy", "run_cell", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

#: The production meshes (``launch.mesh.PRODUCTION_MESHES``) and one card.
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16)),
          "card": (("data", "model"), (1, 1))}

#: Cells whose record is ``ok: false`` on both production meshes, with the
#: reason: none, every cell traces.
KNOWN_FAILURES: dict[tuple[str, str], str] = {}

_NO_COUNTERPART = {
    "bytes_accessed": "XLA's count of the fused program's HBM bytes; the "
                      "port counts op_bytes, each eager operation's operands",
    "bf16_arg_bytes": "an artifact of XLA's lowering for the CPU; the port "
                      "traces the card's own path",
}


def start_fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks in this process (rank
    0), replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_policy(mesh_name: str):
    """The fake process group, the ``DeviceMesh`` (over the CPU: only its
    groups are used) and the policy of ``mesh_name``."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..distributed.sharding import make_policy

    names, shape = MESHES[mesh_name]
    world = 1
    for n in shape:
        world *= n
    start_fake_group(world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    return make_policy(mesh)


def _record(plan, result: dict, mesh_name: str, chips: int) -> dict:
    from ..core.gpu_model import roofline

    ledger = result["ledger"]
    collectives = ledger.summary()
    collectives["by_tag"] = ledger.by_tag()
    report = roofline(
        cell=f"{plan.arch}__{plan.shape}", chips=chips,
        flops_per_chip=result["flops"], hbm_bytes_per_chip=result["op_bytes"],
        collective_bytes_per_chip=ledger.total_wire_bytes_per_chip,
        model_flops=plan.model_flops, dtype=plan.dtype)
    return {
        "memory": {"state_bytes": plan.state_bytes(),
                   "arg_bytes": result["arg_bytes"],
                   "peak_bytes": result["peak_bytes"],
                   "peak_by_op": result["peak_by_op"]},
        "cost": {"flops": result["flops"], "k5_flops": result["k5_flops"],
                 "op_bytes": result["op_bytes"]},
        "collectives": collectives,
        "roofline": report.row(),
    }


def run_cell(arch_name: str, shape_name: str, mesh_name: str, policy, *,
             out_dir: Path = RESULTS_DIR, force: bool = False,
             batch=None, row_cap=None, max_seq=None) -> dict:
    """Trace one cell under ``policy`` (:func:`mesh_policy`) and write its
    record (reused from ``out_dir`` unless ``force``)."""
    from ..configs import get_arch
    from .steps import plan as make_plan
    from .steps import trace_device

    out = Path(out_dir) / mesh_name
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch_name}__{shape_name}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    dev = trace_device()
    record: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                    "chips": policy.n_devices, "trace_device": str(dev),
                    "no_counterpart": _NO_COUNTERPART}
    t0 = time.perf_counter()
    try:
        arch = get_arch(arch_name)
        plan = make_plan(arch, arch.shapes[shape_name], policy, batch=batch,
                         row_cap=row_cap, max_seq=max_seq)
        record.update(kind=plan.kind, model_flops=plan.model_flops,
                      meta={k: str(v) for k, v in plan.meta.items()},
                      **({"notes": plan.notes} if plan.notes else {}))
        result = plan.trace(dev)
        record.update(ok=True, trace_s=round(time.perf_counter() - t0, 3),
                      **_record(plan, result, mesh_name, policy.n_devices))
    except Exception as exc:  # noqa: BLE001 - a failing cell is a record
        record.update(ok=False, trace_s=round(time.perf_counter() - t0, 3),
                      error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
    path.write_text(json.dumps(record, indent=2, default=str))
    return record


_CURRENT: dict = {}


def _cell_in_worker(mesh_name: str, arch: str, shape: str, kw: dict) -> dict:
    """One cell in a worker process, which keeps the fake group and the
    policy of the last mesh it traced."""
    if _CURRENT.get("mesh") != mesh_name:
        _CURRENT.update(mesh=mesh_name, policy=mesh_policy(mesh_name))
    return run_cell(arch, shape, mesh_name, _CURRENT["policy"], **kw)


def _records(cells: list, kw: dict, jobs: int):
    """The records of ``cells`` ((mesh, arch, shape) in order), in that
    order: traced here, or by ``jobs`` worker processes (spawned, each
    with its own fake group)."""
    if jobs <= 1:
        for mesh_name, arch, shape in cells:
            yield _cell_in_worker(mesh_name, arch, shape, kw)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_cell_in_worker, m, a, s, kw)
                   for m, a, s in cells]
        for f in futures:
            yield f.result()


def main(argv=None) -> int:
    from ..configs import all_archs, get_arch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace every (arch x shape x mesh) cell as one rank "
                    "under fake tensors and write one record a cell.")
    ap.add_argument("--arch", default=None,
                    help="an architecture, or several split by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several split by commas")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--batch", type=int, default=None,
                    help="cut an LM or DLRM cell's batch, or a sampled "
                         "GNN cell's seeds (with --mesh card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many worker processes")
    ap.add_argument("--row-cap", type=int, default=None,
                    help="cap every DLRM table's rows (with --mesh card)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="a prefill's cache length (with --mesh card)")
    args = ap.parse_args(argv)
    if (args.batch or args.row_cap or args.max_seq) and args.mesh != "card":
        ap.error("--batch, --row-cap and --max-seq cut the cells of --mesh "
                 "card only")

    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    archs = ([get_arch(a) for a in args.arch.split(",")] if args.arch
             else all_archs())
    cells = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in (args.shape.split(",") if args.shape
                          else list(arch.shapes)):
                if shape not in arch.shapes:
                    continue  # the filter names a shape of another family
                if shape in arch.skips:
                    print(f"[{mesh_name}] {arch.name} x {shape}: SKIP "
                          f"({arch.skips[shape]})", flush=True)
                    continue
                cells.append((mesh_name, arch.name, shape))
    kw = dict(out_dir=args.out, force=args.force, batch=args.batch,
              row_cap=args.row_cap, max_seq=args.max_seq)
    failures = 0
    for rec in _records(cells, kw, args.jobs):
        head = f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}"
        if rec.get("ok"):
            c, m, r = rec["cost"], rec["memory"], rec["roofline"]
            print(f"{head}: OK flops/chip={c['flops']:.4e} "
                  f"op_bytes={c['op_bytes']:.4e} "
                  f"coll={rec['collectives']['wire_bytes_per_chip']:.4e} "
                  f"state={m['state_bytes']:.4e} peak={m['peak_bytes']:.4e} "
                  f"step>={r['step_time_s']:.4e}s ({r['dominant']}) "
                  f"(trace {rec['trace_s']} s)", flush=True)
        else:
            failures += 1
            print(f"{head}: FAIL {rec['error']}", flush=True)
    print(f"dry-run complete; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
