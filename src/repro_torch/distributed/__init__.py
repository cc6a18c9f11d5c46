"""Distribution substrate of the port.  So far it holds the sharded trace
pipeline, :mod:`repro_torch.distributed.trace_shard` (NumPy over a thread
pool), and the training loop's fault tolerance,
:mod:`repro_torch.distributed.resilience` (no collective), both loaded
lazily so that importing this package stays cheap.

The meshes, sharding policies, collectives and pipeline parallelism of the
reference's ``distributed`` package are not ported yet.
"""

__all__ = ["trace_shard", "resilience"]


def __getattr__(name: str):
    # importlib.import_module, not `from . import x`: the latter probes
    # this very __getattr__ via hasattr before importing -> recursion.
    import importlib

    if name in __all__:
        return importlib.import_module(".trace_shard", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
