"""``Scenario``: one (dataflow x graph x hardware x composition) evaluation
as pure, serializable data (a copy of the reference's
``repro/api/scenario.py`` for the ``tile``, ``full`` and ``trace`` kinds).

Graph kinds
-----------
``tile``  the paper's Table II single-tile parameters ``N, T, K, L, P``.
``full``  a whole graph ``V, E, N, T`` (plus ``high_degree_fraction``),
          evaluated through the composition layer; needs a
          :class:`Composition` with ``tile_vertices``.
``trace`` an actual graph: ``{"kind": "trace", "dataset": name, "params":
          {...}, "N": ..., "T": ...}`` references a registered trace
          dataset (:mod:`repro_torch.core.trace`), and the exact edge-list
          schedule, counted by kernel K4, replaces the uniform-tile
          approximation.  Needs ``tile_vertices`` and forbids
          ``halo_dedup != 1``.

The reference's ``hetero`` and ``minibatch`` kinds, ``optimize`` blocks and
``conformance=True`` are not ported yet; each raises a ``ValueError`` that
names the ROADMAP item that brings it.  ``expect`` optionally pins
``total_bits`` / ``total_iterations``, so a checked-in scenario file is a
golden-drift gate.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence

__all__ = [
    "Composition",
    "Scenario",
    "TILE_GRAPH_FIELDS",
    "FULL_GRAPH_FIELDS",
    "TRACE_GRAPH_FIELDS",
    "NOT_PORTED",
    "load_scenarios",
]

#: Table II single-tile graph parameters, in the paper's order.
TILE_GRAPH_FIELDS = ("N", "T", "K", "L", "P")
#: Full-graph (composition-layer) parameters; high_degree_fraction optional.
FULL_GRAPH_FIELDS = ("V", "E", "N", "T")
#: Trace-graph required fields; ``params`` / ``high_degree_fraction`` optional.
TRACE_GRAPH_FIELDS = ("dataset", "N", "T")

#: Reference scenario features the port does not evaluate yet, and the
#: ROADMAP.md item that brings each.
NOT_PORTED = {
    "hetero": "ROADMAP.md Queue 1 item 4a (typed traces)",
    "minibatch": "ROADMAP.md Queue 1 item 4d (sampled minibatches)",
    "optimize": "ROADMAP.md Queue 1 item 4e (the design-space tuner)",
    "conformance": "ROADMAP.md Queue 1 item 3 (front-door conformance)",
}

_RESIDENCIES = ("spill", "resident")


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} scenarios are not ported to repro_torch yet; "
                      f"see {NOT_PORTED[what]}")


def _require_number(value: Any, what: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"{what} must be a plain number (scenarios are pure "
                        f"data); got {value!r} of type {type(value).__name__}")
    out = float(value)
    if not math.isfinite(out):
        raise ValueError(f"{what} must be finite, got {value!r}")
    return out


def _require_nonneg(value: Any, what: str) -> float:
    out = _require_number(value, what)
    if out < 0:
        raise ValueError(f"{what} must be non-negative, got {value!r}: a "
                         "negative graph quantity silently produces "
                         "negative movement totals")
    return out


def _require_fraction(value: Any, what: str) -> float:
    out = _require_nonneg(value, what)
    if out > 1.0:
        raise ValueError(f"{what} is a fraction of the tile's vertices and "
                         f"must be <= 1, got {value!r}")
    return out


@dataclass(frozen=True)
class Composition:
    """Declarative composition policy: layer widths + residency + tiling.

    ``widths`` (``[N_0, ..., N_L]``, >= 2 entries) chains L layers;
    ``tile_vertices`` (>= 1) covers a full graph with a tile schedule and
    halo reloads (``halo_dedup >= 1`` divides halo traffic).  Both are
    optional and compose; a ``Composition()`` with neither is rejected.
    """

    widths: Optional[tuple] = None
    residency: str = "spill"
    tile_vertices: Optional[float] = None
    halo_dedup: float = 1.0

    def __post_init__(self) -> None:
        if self.widths is not None:
            if any(isinstance(x, (list, tuple)) for x in self.widths):
                raise _not_ported("hetero")
            w = tuple(_require_nonneg(x, "Composition.widths entry")
                      for x in self.widths)
            if len(w) < 2:
                raise ValueError(f"Composition.widths needs >= 2 entries "
                                 f"(got {list(w)}): a layer maps "
                                 "widths[l] -> widths[l+1]")
            object.__setattr__(self, "widths", w)
        if isinstance(self.residency, (list, tuple)):
            raise _not_ported("hetero")
        if self.residency not in _RESIDENCIES:
            raise ValueError(f"unknown residency {self.residency!r}; "
                             f"expected one of {_RESIDENCIES}")
        if self.tile_vertices is not None:
            tv = _require_number(self.tile_vertices, "Composition.tile_vertices")
            if tv < 1:
                raise ValueError(f"Composition.tile_vertices must be >= 1, "
                                 f"got {self.tile_vertices!r}")
            object.__setattr__(self, "tile_vertices", tv)
        object.__setattr__(self, "halo_dedup",
                           _require_number(self.halo_dedup,
                                           "Composition.halo_dedup"))
        if self.halo_dedup < 1.0:
            raise ValueError("Composition.halo_dedup must be >= 1 "
                             "(it divides halo traffic)")
        if self.widths is None and self.tile_vertices is None:
            raise ValueError("empty Composition: give widths (multi-layer) "
                             "and/or tile_vertices (full-graph tiling), or "
                             "omit the composition entirely")
        # Reject knobs that would be silently ignored.
        if self.widths is None and self.residency != "spill":
            raise ValueError(
                f"residency={self.residency!r} without widths has no "
                "effect (residency governs inter-layer hand-off); give "
                "widths or drop the residency")
        if self.tile_vertices is None and self.halo_dedup != 1.0:
            raise ValueError(
                f"halo_dedup={self.halo_dedup!r} without tile_vertices has "
                "no effect (it divides inter-tile halo traffic); give "
                "tile_vertices or drop the halo_dedup")

    @property
    def n_layers(self) -> Optional[int]:
        return None if self.widths is None else len(self.widths) - 1

    def signature(self) -> tuple:
        """Structural part of the plan key: layer count, residency,
        tiled-or-not and the scalar halo_dedup must match for two scenarios
        to share one broadcast evaluation; widths values and tile_vertices
        stack."""
        return (self.n_layers, self.residency,
                self.tile_vertices is not None, self.halo_dedup)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.widths is not None:
            out["widths"] = list(self.widths)
        if self.residency != "spill":
            out["residency"] = self.residency
        if self.tile_vertices is not None:
            out["tile_vertices"] = self.tile_vertices
        if self.halo_dedup != 1.0:
            out["halo_dedup"] = self.halo_dedup
        return out

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "Composition":
        known = {"widths", "residency", "tile_vertices", "halo_dedup"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown Composition keys {sorted(unknown)}; "
                             f"expected a subset of {sorted(known)}")
        widths = data.get("widths")
        return cls(
            widths=None if widths is None else tuple(widths),
            residency=data.get("residency", "spill"),
            tile_vertices=data.get("tile_vertices"),
            halo_dedup=data.get("halo_dedup", 1.0),
        )


def _normalized_trace_graph(graph: Mapping[str, Any]) -> dict:
    keys = set(graph)
    missing = set(TRACE_GRAPH_FIELDS) - keys
    if missing:
        raise ValueError(f"trace scenario is missing {sorted(missing)}; "
                         f"required: {TRACE_GRAPH_FIELDS} "
                         "(plus optional params / high_degree_fraction)")
    allowed = set(TRACE_GRAPH_FIELDS) | {"kind", "params",
                                         "high_degree_fraction"}
    extra = keys - allowed
    if extra:
        raise ValueError(f"unknown trace-graph keys {sorted(extra)}; "
                         f"allowed: {sorted(allowed)}")
    dataset = graph["dataset"]
    if not isinstance(dataset, str) or not dataset:
        raise ValueError(f"graph.dataset must be a non-empty registered "
                         f"trace-dataset name, got {dataset!r}")
    params = graph.get("params", {})
    if not isinstance(params, Mapping):
        raise ValueError(f"graph.params must be a mapping of numeric "
                         f"dataset parameters, got {params!r}")
    return {
        "kind": "trace",
        "dataset": dataset,
        "params": {str(k): _require_number(v, f"graph.params.{k}")
                   for k, v in params.items()},
        "N": _require_nonneg(graph["N"], "graph.N"),
        "T": _require_nonneg(graph["T"], "graph.T"),
        "high_degree_fraction": _require_fraction(
            graph.get("high_degree_fraction", 0.1),
            "graph.high_degree_fraction"),
    }


def _normalized_graph(graph: Mapping[str, Any]) -> tuple[dict, str]:
    keys = set(graph)
    kind = graph.get("kind")
    if kind in ("hetero", "minibatch"):
        raise _not_ported(kind)
    if kind is not None and kind != "trace":
        raise ValueError(f"unknown graph kind {kind!r}; the explicit kind "
                         "is 'trace' (tile and full graphs are recognized "
                         "by their field sets)")
    if kind == "trace" or "dataset" in keys:
        return _normalized_trace_graph(graph), "trace"
    if {"V", "E"} & keys:
        missing = set(FULL_GRAPH_FIELDS) - keys
        if missing:
            raise ValueError(f"full-graph scenario is missing {sorted(missing)}; "
                             f"required: {FULL_GRAPH_FIELDS}")
        allowed = set(FULL_GRAPH_FIELDS) | {"high_degree_fraction"}
        extra = keys - allowed
        if extra:
            raise ValueError(f"unknown full-graph keys {sorted(extra)}; "
                             f"allowed: {sorted(allowed)}")
        out = {f: _require_nonneg(graph[f], f"graph.{f}")
               for f in FULL_GRAPH_FIELDS}
        out["high_degree_fraction"] = _require_fraction(
            graph.get("high_degree_fraction", 0.1),
            "graph.high_degree_fraction")
        return out, "full"
    missing = set(TILE_GRAPH_FIELDS) - keys
    extra = keys - set(TILE_GRAPH_FIELDS)
    if missing or extra:
        raise ValueError(
            f"tile scenario graph must give exactly {TILE_GRAPH_FIELDS} "
            f"(missing {sorted(missing)}, unknown {sorted(extra)}); "
            "use Scenario.tile(...) to fill the paper's defaults, give "
            "V/E for a full-graph scenario, or kind='trace' with a "
            "dataset reference for an exact edge-list scenario")
    return ({f: _require_number(graph[f], f"graph.{f}")
             for f in TILE_GRAPH_FIELDS}, "tile")


@dataclass(frozen=True)
class Scenario:
    """One declarative, JSON-round-trippable evaluation request.

    Attributes:
      dataflow: registered dataflow name (``repro_torch.core.registry``).
      graph: tile, full-graph or trace parameters (see the module doc).
      hardware: overrides applied to the dataflow's default hardware
        record; keys must be fields of that record.
      composition: optional policy (layer widths / residency / tiling).
      conformance: not ported yet; ``True`` raises.
      expect: optional pinned ``total_bits`` / ``total_iterations``.
      label / workload: free-form identification carried through results.
      optimize: not ported yet; a block raises.
    """

    dataflow: str
    graph: Mapping[str, float]
    hardware: Mapping[str, float] = field(default_factory=dict)
    composition: Optional[Composition] = None
    conformance: bool = False
    expect: Optional[Mapping[str, float]] = None
    label: str = ""
    workload: str = ""
    optimize: Optional[Mapping[str, Any]] = None

    def __post_init__(self) -> None:
        if not isinstance(self.dataflow, str) or not self.dataflow:
            raise ValueError(f"dataflow must be a non-empty accelerator "
                             f"name, got {self.dataflow!r}")
        if self.optimize is not None:
            raise _not_ported("optimize")
        if self.conformance:
            raise _not_ported("conformance")
        graph, kind = _normalized_graph(dict(self.graph))
        object.__setattr__(self, "graph", graph)
        object.__setattr__(self, "_graph_kind", kind)
        hardware = {str(k): _require_number(v, f"hardware.{k}")
                    for k, v in dict(self.hardware).items()}
        object.__setattr__(self, "hardware", hardware)
        if self.composition is not None and not isinstance(self.composition,
                                                           Composition):
            object.__setattr__(self, "composition",
                               Composition.from_dict(self.composition))
        tiled = (self.composition is not None
                 and self.composition.tile_vertices is not None)
        if kind == "full" and not tiled:
            raise ValueError(
                "a full-graph scenario (V/E) needs a composition with "
                "tile_vertices: the tile schedule is what maps V/E onto "
                "the per-tile closed forms")
        if kind == "tile" and tiled:
            raise ValueError(
                "tile_vertices tiling requires a full-graph scenario "
                "(give V/E instead of K/L/P)")
        if kind == "trace":
            if not tiled:
                raise ValueError(
                    "a trace scenario needs a composition with "
                    "tile_vertices: the capacity sets the exact tile "
                    "schedule the edge list is partitioned into")
            if self.composition.halo_dedup != 1.0:
                raise ValueError(
                    "halo_dedup must stay 1 for a trace scenario: the "
                    "exact schedule already deduplicates remote sources "
                    "per tile, so a divisor would double-count the dedup")
        if self.expect is not None:
            known = {"total_bits", "total_iterations"}
            unknown = set(self.expect) - known
            if unknown:
                raise ValueError(f"unknown expect keys {sorted(unknown)}; "
                                 f"expected a subset of {sorted(known)}")
            object.__setattr__(self, "expect", {
                k: _require_number(v, f"expect.{k}")
                for k, v in dict(self.expect).items()})

    # -- constructors -----------------------------------------------------
    @classmethod
    def tile(cls, dataflow: str, *, K: float = 1024.0, N: float = 30.0,
             T: float = 5.0, L: Optional[float] = None,
             P: Optional[float] = None, edge_factor: float = 10.0,
             high_degree_fraction: float = 0.1, **kw: Any) -> "Scenario":
        """Single-tile scenario at the paper's Sec. IV defaults: unless
        given, ``L = floor(K * high_degree_fraction)`` and ``P = K *
        edge_factor``."""
        K = _require_number(K, "K")
        graph = {
            "N": _require_number(N, "N"), "T": _require_number(T, "T"),
            "K": K,
            "L": (math.floor(K * high_degree_fraction) if L is None
                  else _require_number(L, "L")),
            "P": K * edge_factor if P is None else _require_number(P, "P"),
        }
        return cls(dataflow=dataflow, graph=graph, **kw)

    @classmethod
    def full_graph(cls, dataflow: str, *, V: float, E: float, N: float,
                   T: float, tile_vertices: float = 1024.0,
                   widths: Optional[Sequence[float]] = None,
                   residency: str = "spill", halo_dedup: float = 1.0,
                   high_degree_fraction: float = 0.1, **kw: Any) -> "Scenario":
        """Full-graph scenario: tile schedule + optional multi-layer chain."""
        comp = Composition(
            widths=None if widths is None else tuple(widths),
            residency=residency, tile_vertices=tile_vertices,
            halo_dedup=halo_dedup)
        graph = {"V": V, "E": E, "N": N, "T": T,
                 "high_degree_fraction": high_degree_fraction}
        return cls(dataflow=dataflow, graph=graph, composition=comp, **kw)

    @classmethod
    def trace(cls, dataflow: str, *, dataset: str,
              params: Optional[Mapping[str, float]] = None, N: float,
              T: float, tile_vertices: float = 1024.0,
              widths: Optional[Sequence[float]] = None,
              residency: str = "spill",
              high_degree_fraction: float = 0.1, **kw: Any) -> "Scenario":
        """Trace scenario: exact edge-list schedule over a named dataset
        (V/E come from the resolved edge list)."""
        comp = Composition(
            widths=None if widths is None else tuple(widths),
            residency=residency, tile_vertices=tile_vertices)
        graph = {"kind": "trace", "dataset": dataset,
                 "params": dict(params or {}), "N": N, "T": T,
                 "high_degree_fraction": high_degree_fraction}
        return cls(dataflow=dataflow, graph=graph, composition=comp, **kw)

    # -- structure --------------------------------------------------------
    def _graph_key(self) -> tuple:
        """Canonical hashable view of the graph mapping (nested params)."""
        return tuple(
            (k, tuple(sorted(v.items())) if isinstance(v, Mapping) else v)
            for k, v in sorted(self.graph.items()))

    def __hash__(self) -> int:
        expect = (None if self.expect is None
                  else tuple(sorted(self.expect.items())))
        return hash((self.dataflow, self._graph_key(),
                     tuple(sorted(self.hardware.items())), self.composition,
                     expect, self.label, self.workload))

    @property
    def graph_kind(self) -> str:
        """``"tile"``, ``"full"`` or ``"trace"``."""
        return self._graph_kind  # type: ignore[attr-defined]

    def plan_key(self) -> tuple:
        """Hashable signature of everything that cannot batch numerically.

        Scenarios sharing a plan key differ only in numeric leaves, which
        stack along one batch axis for a single broadcast evaluation.  For
        trace scenarios the dataset reference is structural, but the tile
        capacity is not: same-dataset trace scenarios differing only in
        ``tile_vertices`` stack along the capacity axis, all schedules
        sharing one factorization.
        """
        comp = None if self.composition is None else self.composition.signature()
        key = (self.dataflow, self.graph_kind,
               tuple(sorted(self.hardware)), comp)
        if self.graph_kind == "trace":
            key += (self.graph["dataset"],
                    tuple(sorted(self.graph["params"].items())))
        return key

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        graph = {k: dict(v) if isinstance(v, Mapping) else v
                 for k, v in self.graph.items()}
        out: dict[str, Any] = {"dataflow": self.dataflow, "graph": graph}
        if self.hardware:
            out["hardware"] = dict(self.hardware)
        if self.composition is not None:
            out["composition"] = self.composition.to_dict()
        if self.expect is not None:
            out["expect"] = dict(self.expect)
        if self.label:
            out["label"] = self.label
        if self.workload:
            out["workload"] = self.workload
        return out

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "Scenario":
        known = {"dataflow", "graph", "hardware", "composition",
                 "conformance", "expect", "label", "workload", "optimize"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown Scenario keys {sorted(unknown)}; "
                             f"expected a subset of {sorted(known)}")
        for req in ("dataflow", "graph"):
            if req not in data:
                raise ValueError(f"Scenario is missing required key {req!r}")
        comp = data.get("composition")
        return cls(
            dataflow=data["dataflow"],
            graph=data["graph"],
            hardware=data.get("hardware", {}),
            composition=(None if comp is None else
                         Composition.from_dict(comp)),
            conformance=bool(data.get("conformance", False)),
            expect=data.get("expect"),
            label=data.get("label", ""),
            workload=data.get("workload", ""),
            optimize=data.get("optimize"),
        )

    def to_json(self, **json_kw: Any) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **json_kw)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    def replace(self, **kw: Any) -> "Scenario":
        return dataclasses.replace(self, **kw)


def load_scenarios(path: str) -> list[Scenario]:
    """Read a batch file: ``{"scenarios": [...]}`` or a bare JSON list."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, Mapping):
        if "scenarios" not in data:
            raise ValueError(f"{path}: scenario batch object must carry a "
                             "'scenarios' list")
        data = data["scenarios"]
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a scenario list or "
                         "{'scenarios': [...]} object")
    return [Scenario.from_dict(d) for d in data]
