"""Distribution substrate of the port: the sharded trace pipeline
(:mod:`.trace_shard`, NumPy over a thread pool), the training loop's fault
tolerance (:mod:`.resilience`), and the ``torch.distributed`` substrate:
the counted collectives (:mod:`.comm`), sharding policies over a device
mesh (:mod:`.sharding`), the ring and all-gather SpMM (:mod:`.ring`) and
GPipe (:mod:`.pipeline_par`).

Every name is loaded lazily, so that importing this package stays cheap;
``ShardingPolicy`` and ``make_policy`` come from :mod:`.sharding`, as the
reference re-exports them.
"""

__all__ = ["ShardingPolicy", "make_policy", "comm", "pipeline_par",
           "resilience", "ring", "sharding", "trace_shard"]

_SUBMODULES = ("comm", "pipeline_par", "resilience", "ring", "sharding",
               "trace_shard")


def __getattr__(name: str):
    # importlib.import_module, not `from . import x`: the latter probes
    # this very __getattr__ via hasattr before importing -> recursion.
    import importlib

    if name in ("ShardingPolicy", "make_policy"):
        return getattr(importlib.import_module(".sharding", __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
