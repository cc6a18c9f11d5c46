"""Distribution substrate of the port.  So far it holds only the sharded
trace pipeline, :mod:`repro_torch.distributed.trace_shard` (NumPy over a
thread pool), loaded lazily so that importing this package stays cheap.

The meshes, sharding policies, collectives and pipeline parallelism of the
reference's ``distributed`` package are not ported yet.
"""

__all__ = ["trace_shard"]


def __getattr__(name: str):
    # importlib.import_module, not `from . import x`: the latter probes
    # this very __getattr__ via hasattr before importing -> recursion.
    import importlib

    if name == "trace_shard":
        return importlib.import_module(".trace_shard", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
