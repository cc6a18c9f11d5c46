"""Workload -> scenario bridges: the paper's tile language as queries (the
reference's ``configs/scenarios.py``).

Each workload config (``configs/<id>.py``) describes a real architecture;
this module translates one (architecture, input shape) cell into the
paper's (N, T, K, L, P) tile language and emits one evaluable
:class:`repro_torch.api.Scenario` per requested dataflow, so the movement
totals of smollm, gemma2, equiformer-v2 or dlrm across all five registered
dataflows are a one-line query::

    from repro_torch.api import evaluate_scenarios
    from repro_torch.configs import get_arch
    res = evaluate_scenarios(get_arch("gemma2-2b").to_scenarios(),
                             device="cpu")

Family mappings:

* **lm** — attention read as a dense GNN on a banded graph: one sequence
  is one tile of K = seq token-vertices; the tightest attention window W
  (full-causal layers contribute W = seq) bounds the per-token
  neighborhood, so P = K * W; the layer stack chains via a multi-layer
  composition with widths ``[d_model] * (n_layers + 1)``.
* **gnn** — the graph is the graph: V/E from the shape (graph-batched
  shapes multiply by ``batch``), feature widths from the model config
  (the per-arch ``scenario_widths`` hook; EquiformerV2 flattens irreps to
  ``(l_max+1)^2 * C``), covered by a tile schedule (full-graph scenario),
  or, with ``graph_kind="trace"`` / ``"hetero"``, by the exact schedule of
  a seeded edge list at the shape's V/E, counted by kernel K4.
* **recsys** — the embedding gather is the aggregation: a batch of
  examples is a tile of K = batch destination vertices, each pulling
  ``n_sparse * multi_hot`` embedding rows (P edges) of N = embed_dim
  features; combination is the interaction + top MLP (T = its output).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from .base import ArchDef, ShapeSpec

__all__ = ["arch_scenarios"]


def _widths(arch: ArchDef, cfg: Any, params: Mapping[str, Any],
            fallback) -> tuple[float, ...]:
    fn = arch.scenario_widths or fallback
    return tuple(float(w) for w in fn(cfg, params))


def _lm_generic_widths(cfg: Any, params: Mapping[str, Any]) -> list[float]:
    return [cfg.d_model] * (cfg.n_layers + 1)


def _gnn_generic_widths(cfg: Any, params: Mapping[str, Any]) -> list[float]:
    d_in = params.get("d_feat", getattr(cfg, "d_in", None))
    if d_in is None:
        raise ValueError(f"cannot infer feature widths for {cfg!r}; give the "
                         "arch a scenario_widths hook")
    return ([d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [getattr(cfg, "n_classes", getattr(cfg, "d_out", cfg.d_hidden))])


def _lm_scenarios(arch: ArchDef, shape: ShapeSpec, dataflows, Scenario,
                  *, high_degree_fraction: float, **_kw) -> list:
    cfg = arch.make_config()
    seq = float(shape.params["seq"])
    pattern = getattr(cfg, "window_pattern", (None,)) or (None,)
    windows = [seq if w is None else float(w) for w in pattern]
    W = min(min(windows), seq)
    widths = _widths(arch, cfg, shape.params, _lm_generic_widths)
    return [
        Scenario.tile(
            df, K=seq, N=widths[0], T=widths[-1], P=seq * W,
            high_degree_fraction=high_degree_fraction,
            composition={"widths": list(widths), "residency": "spill"},
            label=f"{arch.name}/{shape.name}@{df}",
            workload=f"{arch.name}/{shape.name}")
        for df in dataflows
    ]


def _gnn_trace_dataset(arch: ArchDef, shape: ShapeSpec) -> tuple[str, dict]:
    """The deterministic trace dataset behind a GNN shape.

    Batched molecular shapes resolve to the block-diagonal ``molecule``
    union graph; the Cora cell resolves to the Cora-sized ``cora``
    dataset; every other shape replays a seeded ``power_law`` graph at
    the shape's exact V/E (self-loop-free, so E matches the shape).
    """
    p = shape.params
    if "batch" in p:
        return "molecule", {"batch": float(p["batch"]),
                            "n_nodes": float(p["n_nodes"]),
                            "n_edges": float(p["n_edges"]),
                            "seed": 0.0, "step": 0.0}
    if arch.name == "gcn-cora" and shape.name == "full_graph_sm":
        return "cora", {}
    return "power_law", {"n_nodes": float(p["n_nodes"]),
                         "n_edges": float(p["n_edges"]), "seed": 0.0}


def _gnn_scenarios(arch: ArchDef, shape: ShapeSpec, dataflows, Scenario,
                   *, tile_vertices: float, high_degree_fraction: float,
                   graph_kind: str = "full", **_kw) -> list:
    p = shape.params
    batch = float(p.get("batch", 1))
    V = float(p["n_nodes"]) * batch
    E = float(p["n_edges"]) * batch
    cfg = arch.make_config()
    widths = _widths(arch, cfg, p, _gnn_generic_widths)
    if graph_kind == "trace":
        dataset, params = _gnn_trace_dataset(arch, shape)
        return [
            Scenario.trace(
                df, dataset=dataset, params=params,
                N=widths[0], T=widths[-1],
                tile_vertices=min(tile_vertices, max(V, 1.0)),
                widths=widths, residency="spill",
                high_degree_fraction=high_degree_fraction,
                label=f"{arch.name}/{shape.name}@{df}/trace",
                workload=f"{arch.name}/{shape.name}")
            for df in dataflows
        ]
    if graph_kind == "hetero":
        # Typed-relation reading of the same shape: the shape's edge budget replays as an R-relation typed power-law
        # graph at the same V/E, each relation carrying its own weight
        # stack (RGCN-style).  n_relations comes from the arch config
        # when it declares one (e.g. edge types), else defaults to 3.
        R = int(getattr(cfg, "n_edge_types", 0) or 3)
        return [
            Scenario.hetero(
                df, dataset="typed_power_law",
                params={"n_nodes": float(V), "n_edges": float(E),
                        "seed": 0.0},
                n_relations=R,
                N=widths[0], T=widths[-1],
                tile_vertices=min(tile_vertices, max(V, 1.0)),
                widths=widths, residency="spill",
                high_degree_fraction=high_degree_fraction,
                label=f"{arch.name}/{shape.name}@{df}/hetero",
                workload=f"{arch.name}/{shape.name}")
            for df in dataflows
        ]
    return [
        Scenario.full_graph(
            df, V=V, E=E, N=widths[0], T=widths[-1],
            tile_vertices=min(tile_vertices, max(V, 1.0)),
            widths=widths, residency="spill",
            high_degree_fraction=high_degree_fraction,
            label=f"{arch.name}/{shape.name}@{df}",
            workload=f"{arch.name}/{shape.name}")
        for df in dataflows
    ]


def _recsys_scenarios(arch: ArchDef, shape: ShapeSpec, dataflows, Scenario,
                      *, high_degree_fraction: float, **_kw) -> list:
    cfg = arch.make_config()
    K = float(shape.params.get("batch", 1)) \
        * float(shape.params.get("n_candidates", 1))
    P = K * cfg.n_sparse * getattr(cfg, "multi_hot", 1)
    T = float(cfg.top_mlp[-1])
    return [
        Scenario.tile(
            df, K=K, N=float(cfg.embed_dim), T=T, P=P,
            high_degree_fraction=high_degree_fraction,
            label=f"{arch.name}/{shape.name}@{df}",
            workload=f"{arch.name}/{shape.name}")
        for df in dataflows
    ]


_FAMILIES = {"lm": _lm_scenarios, "gnn": _gnn_scenarios,
             "recsys": _recsys_scenarios}


def arch_scenarios(arch: ArchDef, *,
                   shapes: Optional[Sequence[str]] = None,
                   dataflows: Optional[Sequence[str]] = None,
                   tile_vertices: float = 1024.0,
                   high_degree_fraction: float = 0.1,
                   graph_kind: str = "full") -> list:
    """One Scenario per (shape, dataflow) for a workload config.

    ``shapes`` defaults to every non-skipped shape of the arch;
    ``dataflows`` to every registered dataflow.  The result is pure data —
    hand it to :func:`repro_torch.api.evaluate_scenarios` (the planner
    batches all of it into one broadcast evaluation per dataflow).

    ``graph_kind="trace"`` (GNN family only) swaps the uniform full-graph
    composition for exact-schedule scenarios over the deterministic trace
    dataset matching each shape; ``graph_kind="hetero"`` (also GNN only)
    reads the shape as an R-relation typed graph at the same V/E, one
    RGCN-style weight stack per relation.
    """
    from ..api.scenario import Scenario
    if arch.family not in _FAMILIES:
        raise ValueError(f"no scenario bridge for family {arch.family!r} "
                         f"(arch {arch.name!r})")
    if graph_kind not in ("full", "trace", "hetero"):
        raise ValueError(f"unknown graph_kind {graph_kind!r}; "
                         "expected 'full', 'trace', or 'hetero'")
    if graph_kind in ("trace", "hetero") and arch.family != "gnn":
        raise ValueError(
            f"graph_kind={graph_kind!r} needs a real edge list, which only "
            f"the gnn family shapes carry (arch {arch.name!r} is "
            f"{arch.family!r}); lm/recsys tiles are synthetic-banded and "
            "stay on the closed-form schedule")
    if dataflows is None:
        from ..core import registry
        dataflows = registry.names()
    shape_names = (tuple(shapes) if shapes is not None
                   else tuple(s for s in arch.shapes if s not in arch.skips))
    out: list = []
    for sname in shape_names:
        if sname not in arch.shapes:
            raise KeyError(f"arch {arch.name!r} has no shape {sname!r}; "
                           f"available: {sorted(arch.shapes)}")
        out.extend(_FAMILIES[arch.family](
            arch, arch.shapes[sname], tuple(dataflows), Scenario,
            tile_vertices=float(tile_vertices),
            high_degree_fraction=float(high_degree_fraction),
            graph_kind=graph_kind))
    return out
