"""The architecture registry's records: one :class:`ArchDef` per
architecture, and the input-shape cells of each family (the reference's
``configs/base.py``).

Each ``configs/<id>.py`` exports an ``ARCH`` binding:

* the published full configuration (``make_config``);
* a reduced configuration of the same family (``make_smoke_config``);
* the shape cells of its family, and the cells it skips, with the reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

__all__ = ["ShapeSpec", "ArchDef", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""

    name: str
    kind: str    # train | prefill | decode | train_sampled | serve | retrieval
    params: Mapping[str, Any]


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq": 524288, "batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               {"n_nodes": 2708, "n_edges": 10556,
                                "d_feat": 1433}),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train_sampled",
                              {"n_nodes": 232965, "n_edges": 114615892,
                               "batch_nodes": 1024, "fanout": (15, 10),
                               "d_feat": 602}),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              {"n_nodes": 2449029, "n_edges": 61859140,
                               "d_feat": 100}),
    "molecule": ShapeSpec("molecule", "train",
                          {"n_nodes": 30, "n_edges": 64, "batch": 128,
                           "d_feat": 16}),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1000000}),
}


@dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                            # "lm" | "gnn" | "recsys"
    make_config: Callable[[], Any]         # full published config
    make_smoke_config: Callable[[], Any]   # reduced same-family config
    shapes: Mapping[str, ShapeSpec]
    # shape name -> reason, for the cells an architecture skips.
    skips: Mapping[str, str] = field(default_factory=dict)
    notes: str = ""
    # The tile-language hook: (config, shape params) -> the per-layer
    # feature widths [N_0, ..., N_L] this architecture chains.  None falls
    # back to the family's mapping in configs/scenarios.py.
    scenario_widths: Optional[Callable[[Any, Mapping[str, Any]],
                                       Sequence[float]]] = None

    def cells(self) -> list[tuple[str, str]]:
        return [(self.name, s) for s in self.shapes if s not in self.skips]

    def to_scenarios(self, *, shapes: Optional[Sequence[str]] = None,
                     dataflows: Optional[Sequence[str]] = None,
                     **kw: Any) -> list:
        """This workload in the paper's (N, T, K, L, P) tile language: one
        :class:`repro_torch.api.Scenario` per (shape, dataflow), which
        ``repro_torch.api.evaluate_scenarios`` answers in one batched
        query (see :func:`.scenarios.arch_scenarios`)."""
        from .scenarios import arch_scenarios
        return arch_scenarios(self, shapes=shapes, dataflows=dataflows, **kw)
