"""Named scenario templates: the paper's figures as declarative batches (a
copy of the reference's ``repro/api/templates.py``).

Each template builds the scenario batch behind one figure; the ``figN_*``
functions of :mod:`repro_torch.core.sweep` evaluate these batches and
reshape the stacked results onto the figure's grid.  A template returns a
:class:`TemplateBatch`: the scenarios plus labelled grid axes (meshgrid
``ij`` order, C-raveled), so both the sweep engine and ``python -m
repro_torch.api --template NAME`` can replay them.

``TEMPLATES`` is the by-name directory served by ``--template`` and
``--list``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..core import registry
from ..core.notation import GraphTileParams, paper_default_graph
from ..core.trace import GraphTrace, register_trace_dataset
from .scenario import Scenario, _trusted_tile

__all__ = [
    "TemplateBatch",
    "TEMPLATES",
    "template",
    "template_names",
    "tile_scenarios_from_graph",
    "trace_scenarios_from_graph",
    "DEFAULT_K_SWEEP",
    "DEFAULT_M_SWEEP",
    "DEFAULT_B_SWEEP",
]

#: The Sec. IV operating ranges of the sweeps.
DEFAULT_K_SWEEP = np.array([64, 128, 256, 512, 1024, 2048, 4096, 8192],
                           dtype=np.float64)
DEFAULT_M_SWEEP = np.array([4, 8, 16, 32, 64, 128, 256], dtype=np.float64)
DEFAULT_B_SWEEP = np.logspace(1, 5, 33, dtype=np.float64)  # 10..100k bits/iter


@dataclass(frozen=True)
class TemplateBatch:
    """A scenario batch plus the labelled grid it flattens (C order)."""

    figure: str
    scenarios: tuple[Scenario, ...]
    axes: Mapping[str, np.ndarray]
    meta: Mapping[str, object] = field(default_factory=dict)

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(len(np.atleast_1d(v)) for v in self.axes.values())


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _grid(*axes: np.ndarray) -> tuple[np.ndarray, ...]:
    return tuple(np.meshgrid(*axes, indexing="ij"))


def tile_scenarios_from_graph(
    dataflow: str,
    graph: GraphTileParams,
    shape: tuple[int, ...],
    hardware: Optional[Mapping[str, np.ndarray]] = None,
    **scenario_kw,
) -> list[Scenario]:
    """Flatten (possibly broadcast/array-valued) tile params to scenarios.

    Every graph field and hardware override is broadcast to ``shape`` and
    C-raveled; cell ``j`` of the flat order becomes one scenario.  The
    planner re-stacks the cells into one broadcast evaluation, so the
    round trip through pure data is bit-identical to evaluating the
    original array-valued graph directly.
    """
    fields = {f: np.broadcast_to(_f64(getattr(graph, f)), shape).ravel()
              for f in ("N", "T", "K", "L", "P")}
    hw = {k: np.broadcast_to(_f64(v), shape).ravel()
          for k, v in (hardware or {}).items()}
    if not np.all([np.isfinite(col).all() for col in fields.values()] +
                  [np.isfinite(col).all() for col in hw.values()]):
        raise ValueError(f"non-finite graph/hardware values for {dataflow!r}")
    # One tolist per column (not one numpy scalar read per cell).
    fnames, fcols = list(fields), [c.tolist() for c in fields.values()]
    hnames, hcols = list(hw), [c.tolist() for c in hw.values()]
    n = int(np.prod(shape)) if shape else 1
    cells = zip(zip(*fcols), zip(*hcols) if hcols else ((),) * n)
    if set(scenario_kw) <= {"label", "workload"}:
        # The values were validated above in one vectorized pass, so the
        # cells take the trusted fast path.
        return [_trusted_tile(dataflow, dict(zip(fnames, cell)),
                              dict(zip(hnames, hcell)), **scenario_kw)
                for cell, hcell in cells]
    return [Scenario(dataflow=dataflow, graph=dict(zip(fnames, cell)),
                     hardware=dict(zip(hnames, hcell)), **scenario_kw)
            for cell, hcell in cells]


def trace_scenarios_from_graph(
    graph,
    name: str,
    *,
    dataflows: Optional[Sequence[str]] = None,
    tile_vertices: Sequence[float] = (1024.0,),
    N: Optional[float] = None,
    T: Optional[float] = None,
    widths: Optional[Sequence[float]] = None,
    residency: str = "spill",
    high_degree_fraction: float = 0.1,
    workload: str = "",
    overwrite: bool = False,
) -> list[Scenario]:
    """Exact-schedule scenarios over an in-memory graph.

    ``graph`` is a :class:`~repro_torch.core.trace.GraphTrace` or anything
    with ``senders``/``receivers``/``n_nodes``.  It is registered as the
    parameterless trace dataset ``name``, and one ``{"kind": "trace"}``
    scenario per (dataflow, tile capacity) referencing it is returned.  The
    scenarios replay only where ``name`` is registered.

    Either ``widths`` (multi-layer chain; N/T default to its endpoints)
    or explicit ``N``/``T`` must be given.
    """
    trace = graph if isinstance(graph, GraphTrace) else GraphTrace.from_arrays(graph)
    if widths is not None:
        widths = tuple(float(w) for w in widths)
        N = widths[0] if N is None else N
        T = widths[-1] if T is None else T
    if N is None or T is None:
        raise ValueError("give widths (multi-layer) or explicit N and T "
                         "feature widths for the trace scenarios")
    register_trace_dataset(name, lambda: trace, overwrite=overwrite)
    names = tuple(dataflows) if dataflows is not None else registry.names()
    return [
        Scenario.trace(df, dataset=name, N=float(N), T=float(T),
                       tile_vertices=float(cap), widths=widths,
                       residency=residency,
                       high_degree_fraction=high_degree_fraction,
                       label=f"{name}@{df}/tile{int(cap)}",
                       workload=workload or name)
        for df in names for cap in tile_vertices
    ]


def fig3(K: Optional[np.ndarray] = None,
         M: Optional[np.ndarray] = None) -> TemplateBatch:
    """Fig. 3: EnGN movement over (tile size K, PE array M = M')."""
    K = _f64(DEFAULT_K_SWEEP if K is None else K)
    M = _f64(DEFAULT_M_SWEEP if M is None else M)
    Kg, Mg = _grid(K, M)
    scenarios = tile_scenarios_from_graph(
        "engn", paper_default_graph(Kg), Kg.shape,
        hardware={"M": Mg, "M_prime": Mg})
    return TemplateBatch(figure="fig3", scenarios=tuple(scenarios),
                         axes={"K": K, "M": M}, meta={"model": "engn"})


def fig4(K: Optional[np.ndarray] = None,
         Ma: Optional[np.ndarray] = None) -> TemplateBatch:
    """Fig. 4: HyGCN movement over (tile size K, SIMD cores Ma)."""
    K = _f64(DEFAULT_K_SWEEP if K is None else K)
    Ma = _f64(DEFAULT_M_SWEEP if Ma is None else Ma)
    Kg, Mag = _grid(K, Ma)
    scenarios = tile_scenarios_from_graph(
        "hygcn", paper_default_graph(Kg), Kg.shape, hardware={"Ma": Mag})
    return TemplateBatch(figure="fig4", scenarios=tuple(scenarios),
                         axes={"K": K, "Ma": Ma}, meta={"model": "hygcn"})


def fig5(accelerator: str, B: Optional[np.ndarray] = None,
         K: Optional[np.ndarray] = None) -> TemplateBatch:
    """Fig. 5: iterations vs L2 bandwidth per workload size, any dataflow."""
    B = _f64(DEFAULT_B_SWEEP if B is None else B)
    K = _f64(np.array([256, 1024, 4096], dtype=np.float64) if K is None else K)
    registry.get(accelerator)  # fail fast on unknown names
    Bg, Kg = _grid(B, K)
    scenarios = tile_scenarios_from_graph(
        accelerator, paper_default_graph(Kg), Bg.shape, hardware={"B": Bg})
    figure = {"engn": "fig5a", "hygcn": "fig5b"}.get(accelerator,
                                                     f"fig5_{accelerator}")
    return TemplateBatch(figure=figure, scenarios=tuple(scenarios),
                         axes={"B": B, "K": K}, meta={"model": accelerator})


def fig6(K: float = 1024.0, M: Optional[np.ndarray] = None) -> TemplateBatch:
    """Fig. 6: EnGN iterations vs the array-fitting factor K*N / M^2."""
    M = _f64(np.array([4, 8, 16, 32, 64, 128, 256, 512], dtype=np.float64)
             if M is None else M)
    scenarios = tile_scenarios_from_graph(
        "engn", paper_default_graph(K), M.shape,
        hardware={"M": M, "M_prime": M})
    return TemplateBatch(figure="fig6", scenarios=tuple(scenarios),
                         axes={"M": M}, meta={"model": "engn", "K": K})


def fig7(gamma: Optional[np.ndarray] = None,
         N: Optional[np.ndarray] = None) -> TemplateBatch:
    """Fig. 7: HyGCN loadweights vs systolic reuse Gamma and depth N."""
    gamma = _f64(np.linspace(0.0, 0.99, 34) if gamma is None else gamma)
    N = _f64(np.array([30, 128, 512], dtype=np.float64) if N is None else N)
    Gg, Ng = _grid(gamma, N)
    scenarios = tile_scenarios_from_graph(
        "hygcn", paper_default_graph(1024.0).replace(N=Ng), Gg.shape,
        hardware={"gamma": Gg})
    return TemplateBatch(figure="fig7", scenarios=tuple(scenarios),
                         axes={"gamma": gamma, "N": N},
                         meta={"model": "hygcn"})


def comparison(accelerators: Optional[Sequence[str]] = None,
               K: Optional[np.ndarray] = None) -> TemplateBatch:
    """Every registered dataflow over one tile-size grid, Sec. IV defaults:
    the batch behind ``sweep_accelerators()``, A dataflows x |K| cells in
    exactly A broadcast calls."""
    names = tuple(accelerators) if accelerators is not None else registry.names()
    K = np.atleast_1d(_f64(DEFAULT_K_SWEEP if K is None else K))
    graph = paper_default_graph(K)
    scenarios: list[Scenario] = []
    for name in names:
        scenarios.extend(tile_scenarios_from_graph(name, graph, K.shape,
                                                   label=name))
    return TemplateBatch(figure="comparison", scenarios=tuple(scenarios),
                         axes={"K": K}, meta={"accelerators": names})


def cora_end_to_end(
        accelerators: Optional[Sequence[str]] = None,
        tile_vertices: Optional[np.ndarray] = None,
        widths: Sequence[float] = (1433, 16, 7),
        V: float = 2708, E: float = 10556,
        residency: str = "spill") -> TemplateBatch:
    """Full-graph composition: L-layer GCN on Cora for every dataflow."""
    names = tuple(accelerators) if accelerators is not None else registry.names()
    caps = np.atleast_1d(_f64(np.array([256, 512, 1024, 2048], np.float64)
                              if tile_vertices is None else tile_vertices))
    widths = tuple(float(w) for w in widths)
    scenarios = tuple(
        Scenario.full_graph(name, V=V, E=E, N=widths[0], T=widths[-1],
                            tile_vertices=float(cap), widths=widths,
                            residency=residency,
                            label=f"{name}@tile{int(cap)}",
                            workload="gcn-cora")
        for name in names for cap in caps)
    return TemplateBatch(figure="cora_end_to_end", scenarios=scenarios,
                         axes={"tile_vertices": caps},
                         meta={"accelerators": names, "widths": widths,
                               "residency": residency})


def cora_trace(
        accelerators: Optional[Sequence[str]] = None,
        tile_vertices: Optional[np.ndarray] = None,
        widths: Sequence[float] = (1433, 16, 7),
        seed: float = 0.0, alpha: float = 1.6,
        residency: str = "spill") -> TemplateBatch:
    """Exact-schedule companion of ``cora_end_to_end``: the same L-layer
    GCN-on-Cora query over the deterministic Cora-sized power-law trace
    (dataset ``"cora"``), one plan group per (dataflow, capacity).  The
    default sweeps a single capacity, one broadcast evaluation per
    dataflow."""
    names = tuple(accelerators) if accelerators is not None else registry.names()
    caps = np.atleast_1d(_f64(np.array([1024], np.float64)
                              if tile_vertices is None else tile_vertices))
    widths = tuple(float(w) for w in widths)
    params = {"seed": float(seed), "alpha": float(alpha)}
    scenarios = tuple(
        Scenario.trace(name, dataset="cora", params=params,
                       N=widths[0], T=widths[-1], tile_vertices=float(cap),
                       widths=widths, residency=residency,
                       label=f"{name}@tile{int(cap)}/trace",
                       workload="gcn-cora-trace")
        for name in names for cap in caps)
    return TemplateBatch(figure="cora_trace", scenarios=scenarios,
                         axes={"tile_vertices": caps},
                         meta={"accelerators": names, "widths": widths,
                               "residency": residency, "dataset": "cora"})


def rgcn_cora(
        accelerators: Optional[Sequence[str]] = None,
        tile_vertices: Optional[np.ndarray] = None,
        widths: Sequence[float] = (1433, 16, 7),
        n_relations: int = 3,
        seed: float = 0.0, alpha: float = 1.6,
        residency: str = "spill") -> TemplateBatch:
    """Typed-graph companion of ``cora_trace``: an R-relation RGCN-style
    layer chain over the deterministic Cora-sized typed power-law trace
    (dataset ``"typed_cora"``).  Every relation carries its own weight
    matrices, so weight-load traffic scales with R while the shared vertex
    set keeps one partition geometry; the planner evaluates all relations
    in one broadcast :class:`~repro_torch.core.compose.RelationalGraphModel`
    call per (dataflow, residency) group, each relation's schedule counted
    by K4."""
    names = tuple(accelerators) if accelerators is not None else registry.names()
    caps = np.atleast_1d(_f64(np.array([1024], np.float64)
                              if tile_vertices is None else tile_vertices))
    widths = tuple(float(w) for w in widths)
    params = {"seed": float(seed), "alpha": float(alpha)}
    scenarios = tuple(
        Scenario.hetero(name, dataset="typed_cora", params=params,
                        n_relations=int(n_relations),
                        N=widths[0], T=widths[-1],
                        tile_vertices=float(cap), widths=widths,
                        residency=residency,
                        label=f"{name}@tile{int(cap)}/rgcn",
                        workload="rgcn-cora-trace")
        for name in names for cap in caps)
    return TemplateBatch(figure="rgcn_cora", scenarios=scenarios,
                         axes={"tile_vertices": caps},
                         meta={"accelerators": names, "widths": widths,
                               "residency": residency,
                               "dataset": "typed_cora",
                               "n_relations": int(n_relations)})


def tune_cora(
        tile_vertices: Optional[np.ndarray] = None,
        widths: Sequence[float] = (1433, 16, 7),
        V: float = 2708, E: float = 10556,
        sram_bits: Optional[float] = None) -> TemplateBatch:
    """The design-space tune of the L-layer GCN-on-Cora workload.

    One optimize scenario searching (all dataflows) x (capacity sweep) x
    (both residencies): with ``sram_bits`` unset the budget is open and the
    result carries the movement-vs-SRAM Pareto frontier; with a budget, the
    cheapest configuration that fits.
    """
    caps = np.atleast_1d(_f64(np.array([256, 512, 1024, 2048], np.float64)
                              if tile_vertices is None else tile_vertices))
    widths = tuple(float(w) for w in widths)
    optimize = {
        "objective": "movement",
        "space": {"dataflow": "all",
                  "tile_vertices": [float(c) for c in caps],
                  "residency": ["spill", "resident"]},
    }
    if sram_bits is not None:
        optimize["budget"] = {"sram_bits": float(sram_bits)}
    scenario = Scenario.full_graph(
        registry.names()[0], V=V, E=E, N=widths[0], T=widths[-1],
        tile_vertices=float(caps[0]), widths=widths,
        label="tune-cora-gcn", workload="gcn-cora",
        optimize=optimize)
    return TemplateBatch(figure="tune_cora", scenarios=(scenario,),
                         axes={"tile_vertices": caps},
                         meta={"widths": widths, "optimize": optimize})


TEMPLATES: dict[str, Callable[..., TemplateBatch]] = {
    "fig3": fig3,
    "fig4": fig4,
    "fig5a": lambda **kw: fig5("engn", **kw),
    "fig5b": lambda **kw: fig5("hygcn", **kw),
    "fig6": fig6,
    "fig7": fig7,
    "comparison": comparison,
    "cora_end_to_end": cora_end_to_end,
    "cora_trace": cora_trace,
    "rgcn_cora": rgcn_cora,
    "tune_cora": tune_cora,
}


def template(name: str, **kw) -> TemplateBatch:
    """Build a named template's scenario batch."""
    try:
        make_batch = TEMPLATES[name]
    except KeyError:
        raise KeyError(f"unknown template {name!r}; "
                       f"available: {template_names()}") from None
    return make_batch(**kw)


def template_names() -> tuple[str, ...]:
    return tuple(TEMPLATES)
