"""Device meshes and the rank launcher.

:func:`make_test_mesh` is the reference's 8-device test mesh, ``(2, 4)``
over ``("data", "model")``, as a ``torch.distributed`` ``DeviceMesh``: it
needs a process group of that many ranks, which :func:`spawn` starts, one
rank a process:

* on ``gloo`` for CPU tensors, rendezvous through ``file://`` in a fresh
  temporary directory, so that concurrent test workers never race for a
  port, with one CPU thread a rank;
* on ``nccl`` with one rank a card (``torch.cuda.set_device(rank)``),
  rendezvous on ``127.0.0.1`` at a free port.  A rank that finds no card
  raises; nothing falls back to gloo or to host memory.

The production meshes (:data:`PRODUCTION_MESHES`) are kept as data, an
:class:`AbstractMesh` of axis names and sizes, for the dry run: the spec
helpers of :class:`repro_torch.distributed.sharding.ShardingPolicy` read
only those.
"""

from __future__ import annotations

import inspect
import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

__all__ = ["AbstractMesh", "PRODUCTION_MESHES", "make_production_mesh",
           "make_test_mesh", "axis_sizes", "spawn"]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no process behind it: what the
    reference's spec helpers read of a ``jax.sharding.Mesh``."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


#: The reference's production meshes: one pod of 256 devices, two of 512.
PRODUCTION_MESHES = {
    "single_pod": AbstractMesh(("data", "model"), (16, 16)),
    "multi_pod": AbstractMesh(("pod", "data", "model"), (2, 16, 16)),
}


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return PRODUCTION_MESHES["multi_pod" if multi_pod else "single_pod"]


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_test_mesh(shape: Sequence[int] = (2, 4),
                   axes: Sequence[str] = ("data", "model"), *,
                   device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the started process group (whose size must be
    the product of ``shape``), on CUDA under NCCL and on the CPU under
    gloo unless ``device_type`` says otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               rendezvous: str, out_dir: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    kw = {}
    if backend == "gloo":
        torch.set_num_threads(1)
    elif backend == "nccl":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() <= rank:
            raise RuntimeError(f"NCCL rank {rank} finds no card (CUDA "
                               f"{'un' if not torch.cuda.is_available() else ''}"
                               f"available, {torch.cuda.device_count()} "
                               "visible)")
        torch.cuda.set_device(rank)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = torch.device("cuda", rank)
    else:
        raise ValueError(f"backend {backend!r}: expected gloo or nccl")
    dist.init_process_group(backend, init_method=rendezvous, rank=rank,
                            world_size=world, **kw)
    try:
        result = fn(rank, world, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str,
          args: tuple = ()) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method), one rank each, inside an initialised default
    process group; return the ranks' results in rank order.  ``fn`` and its
    arguments must pickle: a module-level function.  A rank's exception
    ends the call with that rank's traceback.  ``backend`` has no default:
    ``"nccl"`` runs one rank a card, ``"gloo"`` runs on CPU tensors.

    Under ``nccl`` the rendezvous is ``tcp://127.0.0.1:<free port>`` and
    ``NCCL_DEBUG`` defaults to ``WARN``, so that a failed bootstrap says
    why."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro-torch-spawn-") as tmp:
        if backend == "nccl":
            os.environ.setdefault("NCCL_DEBUG", "WARN")
            rendezvous = f"tcp://127.0.0.1:{_free_port()}"
        else:
            rendezvous = f"file://{Path(tmp) / 'rendezvous'}"
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, backend, rendezvous, tmp, args))
        results = []
        for rank in range(world):
            with open(Path(tmp) / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
