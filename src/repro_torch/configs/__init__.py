"""The architecture registry of the port (the reference's ``configs``):
``get_arch(name)``, ``all_archs()``, ``all_cells()`` and
``workload_scenarios()``, the workload bridges' one-liner.

Each ``configs/<id>.py`` publishes one architecture's config, a reduced
config of the same family and its ``ARCH`` record; every family's model
is ported (``repro_torch.models``).
"""

from . import (arctic_480b, dlrm_mlperf, equiformer_v2, gatedgcn, gcn_cora,
               gemma2_2b, granite_3_2b, meshgraphnet, qwen3_moe_30b_a3b,
               smollm_135m)
from .base import ArchDef, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ShapeSpec

_MODULES = (qwen3_moe_30b_a3b, arctic_480b, granite_3_2b, gemma2_2b,
            smollm_135m, gcn_cora, equiformer_v2, meshgraphnet, gatedgcn,
            dlrm_mlperf)

REGISTRY: dict[str, ArchDef] = {m.ARCH.name: m.ARCH for m in _MODULES}


def get_arch(name: str) -> ArchDef:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_archs() -> list[ArchDef]:
    return list(REGISTRY.values())


def all_cells(*, include_skipped: bool = False) -> list[tuple[str, str, str]]:
    """(arch, shape, status) for the 40-cell grid."""
    out = []
    for arch in all_archs():
        for shape in arch.shapes:
            if shape in arch.skips:
                if include_skipped:
                    out.append((arch.name, shape,
                                f"SKIP: {arch.skips[shape]}"))
            else:
                out.append((arch.name, shape, "run"))
    return out


def workload_scenarios(archs=None, *, dataflows=None, **kw) -> list:
    """One scenario batch over many workloads, every architecture by
    default (sorted by name).

    ``evaluate_scenarios(workload_scenarios(["smollm-135m", "dlrm-mlperf"]),
    device="cpu")`` answers every (workload shape x dataflow) movement
    query in one broadcast evaluation per dataflow.
    """
    names = list(archs) if archs is not None else sorted(REGISTRY)
    out: list = []
    for name in names:
        out.extend(get_arch(name).to_scenarios(dataflows=dataflows, **kw))
    return out


__all__ = ["REGISTRY", "get_arch", "all_archs", "all_cells", "ArchDef",
           "ShapeSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
           "workload_scenarios"]
