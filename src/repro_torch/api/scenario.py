"""``Scenario``: one (dataflow x graph x hardware x composition) evaluation
as pure, serializable data (a copy of the reference's
``repro/api/scenario.py`` for every graph kind).

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
``hetero`` a typed graph: ``{"kind": "hetero", "dataset": ..., "params":
          {...}, "n_relations": R, "N": ..., "T": ...}`` references a
          registered typed trace dataset and evaluates a
          :class:`~repro_torch.core.compose.RelationalGraphModel` over all
          R relations at once, each relation's schedule counted by K4.
          ``N`` / ``T`` (and each ``composition.widths`` entry) may be a
          scalar or a length-R list of per-relation values;
          ``composition.residency`` may be one policy or a length-R list.
          Same tiling rules as ``trace``.
``minibatch`` a sampled-minibatch workload: ``{"kind": "minibatch",
          "dataset": ..., "params": {...}, "batch_nodes": ..., "fanout":
          [...], "n_batches": ..., "seed": ..., "N": ..., "T": ...}``
          measures ``n_batches`` fanout-sampling episodes over the
          dataset's graph (:func:`repro_torch.data.sampler.
          minibatch_schedule`) and charges each episode as one exact
          schedule tile.  ``tile_vertices`` is forbidden (the seed batch is
          the tile).

``conformance=True`` asks for the measured-vs-modeled check of the
dataflow's kernels (one operating point, the port's harness).  ``expect``
optionally pins ``total_bits`` / ``total_iterations``, so a checked-in
scenario file is a golden-drift gate.

An ``optimize`` block turns a full-graph, trace or hetero scenario into a
search request: ``{"optimize": {"objective": "movement", "budget":
{"sram_bits": ...}, "space": {...}}}`` asks the planner for the
objective-minimizing (dataflow, tile capacity, residency, halo policy)
configuration within the space, found by :mod:`repro_torch.core.tune`.
The block is normalized at construction
(:func:`repro_torch.core.tune.normalize_optimize`), and such a scenario may
also pin ``expect.objective`` / ``expect.best_dataflow`` /
``expect.best_tile_vertices``.
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
    "HETERO_GRAPH_FIELDS",
    "MINIBATCH_GRAPH_FIELDS",
    "scenarios_to_dicts",
    "dump_scenarios",
    "load_scenarios",
]

#: Table II single-tile graph parameters, in the paper's order.
TILE_GRAPH_FIELDS = ("N", "T", "K", "L", "P")
#: Full-graph (composition-layer) parameters; high_degree_fraction optional.
FULL_GRAPH_FIELDS = ("V", "E", "N", "T")
#: Trace-graph required fields; ``params`` / ``high_degree_fraction`` optional.
TRACE_GRAPH_FIELDS = ("dataset", "N", "T")
#: Typed-graph required fields; ``params`` / ``high_degree_fraction`` optional.
HETERO_GRAPH_FIELDS = ("dataset", "n_relations", "N", "T")
#: Minibatch required fields; ``params`` / ``seed`` / hdf optional.
MINIBATCH_GRAPH_FIELDS = ("dataset", "batch_nodes", "fanout", "n_batches",
                          "N", "T")

_RESIDENCIES = ("spill", "resident")


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


def _require_count(value: Any, what: str, *, minimum: int = 1) -> int:
    out = _require_number(value, what)
    if out != int(out) or out < minimum:
        raise ValueError(f"{what} must be an integer >= {minimum}, "
                         f"got {value!r}")
    return int(out)


def _number_or_vector(value: Any, what: str):
    """A scalar, or a per-relation list of scalars (hetero graphs)."""
    if isinstance(value, (list, tuple)):
        if not value:
            raise ValueError(f"{what} must not be an empty list; give a "
                             "scalar or one value per relation")
        return tuple(_require_nonneg(v, f"{what}[{i}]")
                     for i, v in enumerate(value))
    return _require_nonneg(value, what)


@dataclass(frozen=True)
class Composition:
    """Declarative composition policy: layer widths + residency + tiling.

    ``widths`` (``[N_0, ..., N_L]``, >= 2 entries) chains L layers;
    ``tile_vertices`` (>= 1) covers a full graph with a tile schedule and
    halo reloads (``halo_dedup >= 1`` divides halo traffic).  Both are
    optional and compose; a ``Composition()`` with neither is rejected.

    For hetero scenarios, each ``widths`` entry may be a length-R list of
    per-relation widths, and ``residency`` may be a length-R list of
    per-relation policies; both are rejected on every other graph kind
    (the relation axis does not exist there).
    """

    widths: Optional[tuple] = None
    residency: Any = "spill"
    tile_vertices: Optional[float] = None
    halo_dedup: float = 1.0

    def __post_init__(self) -> None:
        if self.widths is not None:
            w = tuple(_number_or_vector(x, "Composition.widths entry")
                      for x in self.widths)
            if len(w) < 2:
                raise ValueError(f"Composition.widths needs >= 2 entries "
                                 f"(got {list(w)}): a layer maps "
                                 "widths[l] -> widths[l+1]")
            object.__setattr__(self, "widths", w)
        if isinstance(self.residency, (list, tuple)):
            res = tuple(self.residency)
            if not res:
                raise ValueError("Composition.residency must not be an "
                                 "empty list; give one policy or one "
                                 "policy per relation")
            for p in res:
                if p not in _RESIDENCIES:
                    raise ValueError(f"unknown residency {p!r}; expected "
                                     f"one of {_RESIDENCIES}")
            object.__setattr__(self, "residency", res)
        elif self.residency not in _RESIDENCIES:
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

    def relation_arity(self) -> Optional[int]:
        """Max per-relation vector length used (None if all-scalar)."""
        arities = []
        if self.widths is not None:
            arities += [len(w) for w in self.widths if isinstance(w, tuple)]
        if isinstance(self.residency, tuple):
            arities.append(len(self.residency))
        return max(arities) if arities else None

    def signature(self) -> tuple:
        """Structural part of the plan key: layer count, residency,
        tiled-or-not, the scalar halo_dedup and the per-relation arity of
        each widths entry must match for two scenarios to share one
        broadcast evaluation; widths values and tile_vertices stack."""
        widths_shape = (None if self.widths is None else
                        tuple(len(w) if isinstance(w, tuple) else None
                              for w in self.widths))
        return (self.n_layers, self.residency,
                self.tile_vertices is not None, self.halo_dedup,
                widths_shape)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.widths is not None:
            out["widths"] = [list(w) if isinstance(w, tuple) else w
                             for w in self.widths]
        if self.residency != "spill":
            out["residency"] = (list(self.residency)
                                if isinstance(self.residency, tuple)
                                else self.residency)
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


def _dataset_and_params(graph: Mapping[str, Any], kind: str) -> dict:
    dataset = graph["dataset"]
    if not isinstance(dataset, str) or not dataset:
        raise ValueError(f"graph.dataset must be a non-empty registered "
                         f"trace-dataset name, got {dataset!r}")
    params = graph.get("params", {})
    if not isinstance(params, Mapping):
        raise ValueError(f"graph.params must be a mapping of numeric "
                         f"dataset parameters, got {params!r}")
    return {
        "kind": kind,
        "dataset": dataset,
        "params": {str(k): _require_number(v, f"graph.params.{k}")
                   for k, v in params.items()},
        "high_degree_fraction": _require_fraction(
            graph.get("high_degree_fraction", 0.1),
            "graph.high_degree_fraction"),
    }


def _normalized_hetero_graph(graph: Mapping[str, Any]) -> dict:
    keys = set(graph)
    missing = set(HETERO_GRAPH_FIELDS) - keys
    if missing:
        raise ValueError(f"hetero scenario is missing {sorted(missing)}; "
                         f"required: {HETERO_GRAPH_FIELDS} "
                         "(plus optional params / high_degree_fraction)")
    allowed = set(HETERO_GRAPH_FIELDS) | {"kind", "params",
                                          "high_degree_fraction"}
    extra = keys - allowed
    if extra:
        raise ValueError(f"unknown hetero-graph keys {sorted(extra)}; "
                         f"allowed: {sorted(allowed)}")
    out = _dataset_and_params(graph, "hetero")
    R = _require_count(graph["n_relations"], "graph.n_relations")
    for f in ("N", "T"):
        v = _number_or_vector(graph[f], f"graph.{f}")
        if isinstance(v, tuple) and len(v) != R:
            raise ValueError(
                f"graph.{f} is per-relation but has {len(v)} entries for "
                f"n_relations={R}; give a scalar or exactly R values")
        out[f] = v
    out["n_relations"] = R
    return out


def _normalized_minibatch_graph(graph: Mapping[str, Any]) -> dict:
    keys = set(graph)
    missing = set(MINIBATCH_GRAPH_FIELDS) - keys
    if missing:
        raise ValueError(f"minibatch scenario is missing {sorted(missing)}; "
                         f"required: {MINIBATCH_GRAPH_FIELDS} "
                         "(plus optional params / seed / "
                         "high_degree_fraction)")
    allowed = set(MINIBATCH_GRAPH_FIELDS) | {"kind", "params", "seed",
                                             "high_degree_fraction"}
    extra = keys - allowed
    if extra:
        raise ValueError(f"unknown minibatch-graph keys {sorted(extra)}; "
                         f"allowed: {sorted(allowed)}")
    out = _dataset_and_params(graph, "minibatch")
    fanout = graph["fanout"]
    if not isinstance(fanout, (list, tuple)) or not fanout:
        raise ValueError(f"graph.fanout must be a non-empty list of "
                         f"per-hop neighbor budgets, got {fanout!r}")
    out["fanout"] = tuple(_require_count(f, f"graph.fanout[{i}]")
                          for i, f in enumerate(fanout))
    out["batch_nodes"] = _require_count(graph["batch_nodes"],
                                        "graph.batch_nodes")
    out["n_batches"] = _require_count(graph["n_batches"], "graph.n_batches")
    out["seed"] = _require_count(graph.get("seed", 0), "graph.seed",
                                 minimum=0)
    out["N"] = _require_nonneg(graph["N"], "graph.N")
    out["T"] = _require_nonneg(graph["T"], "graph.T")
    return out


def _normalized_graph(graph: Mapping[str, Any]) -> tuple[dict, str]:
    keys = set(graph)
    kind = graph.get("kind")
    if kind is not None and kind not in ("trace", "hetero", "minibatch"):
        raise ValueError(f"unknown graph kind {kind!r}; the explicit kinds "
                         "are 'trace', 'hetero', and 'minibatch' (tile and "
                         "full graphs are recognized by their field sets)")
    if kind == "hetero":
        return _normalized_hetero_graph(graph), "hetero"
    if kind == "minibatch":
        return _normalized_minibatch_graph(graph), "minibatch"
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
      graph: tile, full-graph, trace, hetero or minibatch parameters (see
        the module doc).
      hardware: overrides applied to the dataflow's default hardware
        record; keys must be fields of that record.
      composition: optional policy (layer widths / residency / tiling).
      conformance: request the measured-vs-modeled check (one operating
        point) for dataflows with a runnable kernel analogue.
      expect: optional pinned totals (``total_bits``,
        ``total_iterations``; plus ``objective`` / ``best_dataflow`` /
        ``best_tile_vertices`` for optimize scenarios).
      label / workload: free-form identification carried through results.
      optimize: optional search block (``objective`` / ``budget`` /
        ``space`` / ``method``), normalized by
        :func:`repro_torch.core.tune.normalize_optimize`.  The planner
        routes such a scenario through the tuner; ``dataflow`` and the
        composition are the search's base point (axes missing from the
        space pin to their values).
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
        if kind in ("trace", "hetero"):
            if not tiled:
                raise ValueError(
                    f"a {kind} scenario needs a composition with "
                    "tile_vertices: the capacity sets the exact tile "
                    "schedule the edge list is partitioned into")
            if self.composition.halo_dedup != 1.0:
                raise ValueError(
                    f"halo_dedup must stay 1 for a {kind} scenario: the "
                    "exact schedule already deduplicates remote sources "
                    "per tile, so a divisor would double-count the dedup")
        if kind == "minibatch" and tiled:
            raise ValueError(
                "a minibatch scenario must not set tile_vertices: each "
                "sampling episode is already one exact schedule tile "
                "(the seed batch), so a second tiling layer has no "
                "meaning")
        arity = (None if self.composition is None
                 else self.composition.relation_arity())
        if kind == "hetero":
            R = self.graph["n_relations"]
            if arity is not None and arity != R:
                raise ValueError(
                    f"per-relation composition values have arity {arity} "
                    f"but the graph declares n_relations={R}; every "
                    "per-relation widths entry / residency list must have "
                    "exactly R entries")
            if self.composition.widths is not None:
                for i, w in enumerate(self.composition.widths):
                    if isinstance(w, tuple) and len(w) != R:
                        raise ValueError(
                            f"composition.widths[{i}] has {len(w)} "
                            f"per-relation entries for n_relations={R}")
            if (isinstance(self.composition.residency, tuple)
                    and len(self.composition.residency) != R):
                raise ValueError(
                    f"composition.residency lists "
                    f"{len(self.composition.residency)} policies for "
                    f"n_relations={R}; give one policy or exactly R")
        elif arity is not None:
            raise ValueError(
                f"per-relation composition values (arity {arity}) are "
                f"only meaningful for a hetero scenario, not kind "
                f"{kind!r}: other graph kinds have no relation axis")
        if self.optimize is not None:
            # The schema lives beside the engine that interprets it
            # (repro_torch.core.tune imports only numpy).
            from ..core.tune import normalize_optimize
            opt = normalize_optimize(self.optimize)
            object.__setattr__(self, "optimize", opt)
            if kind == "tile":
                raise ValueError(
                    "an optimize block needs a full-graph or trace "
                    "scenario: the search axes (tile capacity, residency, "
                    "halo policy) are composition-layer knobs with no "
                    "meaning for a single Table-II tile")
            if kind == "minibatch":
                raise ValueError(
                    "an optimize block cannot attach to a minibatch "
                    "scenario: its search axes (tile capacity, halo "
                    "policy) are tiling knobs, and the episode schedule "
                    "is fixed by the sampler; tune the sampling "
                    "parameters by sweeping scenarios instead")
            if self.conformance:
                raise ValueError(
                    "optimize and conformance are mutually exclusive on "
                    "one scenario: run the conformance check on the tuned "
                    "winner as a concrete scenario instead")
            space = opt["space"]
            if kind in ("trace", "hetero"):
                for h in space.get("halo_dedup", ()):
                    if h != 1.0:
                        raise ValueError(
                            f"space.halo_dedup must stay [1] for a {kind} "
                            "scenario: the exact schedule already "
                            "deduplicates remote sources per tile")
            if ("resident" in space.get("residency", ())
                    and self.composition.widths is None):
                raise ValueError(
                    "space.residency includes 'resident' but the scenario "
                    "has no layer widths; residency governs inter-layer "
                    "hand-off, so give composition.widths")
        if self.expect is not None:
            known = {"total_bits", "total_iterations"}
            if self.optimize is not None:
                known |= {"objective", "best_dataflow", "best_tile_vertices"}
            unknown = set(self.expect) - known
            if unknown:
                raise ValueError(f"unknown expect keys {sorted(unknown)}; "
                                 f"expected a subset of {sorted(known)}")
            normalized: dict[str, Any] = {}
            for k, v in dict(self.expect).items():
                if k == "best_dataflow":
                    if not isinstance(v, str) or not v:
                        raise ValueError(f"expect.best_dataflow must be a "
                                         f"non-empty dataflow name, got {v!r}")
                    normalized[k] = v
                else:
                    normalized[k] = _require_number(v, f"expect.{k}")
            object.__setattr__(self, "expect", normalized)

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

    @classmethod
    def hetero(cls, dataflow: str, *, dataset: str, n_relations: int,
               params: Optional[Mapping[str, float]] = None,
               N: Any = 30.0, T: Any = 5.0,
               tile_vertices: float = 1024.0,
               widths: Optional[Sequence[Any]] = None,
               residency: Any = "spill",
               high_degree_fraction: float = 0.1, **kw: Any) -> "Scenario":
        """Typed-graph scenario: relational schedule over a typed dataset.

        ``N`` / ``T`` / each ``widths`` entry may be a scalar or a
        length-``n_relations`` list; ``residency`` one policy or a
        per-relation list.
        """
        comp = Composition(
            widths=None if widths is None else tuple(widths),
            residency=residency, tile_vertices=tile_vertices)
        graph = {"kind": "hetero", "dataset": dataset,
                 "params": dict(params or {}), "n_relations": n_relations,
                 "N": N, "T": T,
                 "high_degree_fraction": high_degree_fraction}
        return cls(dataflow=dataflow, graph=graph, composition=comp, **kw)

    @classmethod
    def minibatch(cls, dataflow: str, *, dataset: str,
                  params: Optional[Mapping[str, float]] = None,
                  batch_nodes: int, fanout: Sequence[int],
                  n_batches: int, seed: int = 0,
                  N: float = 30.0, T: float = 5.0,
                  widths: Optional[Sequence[float]] = None,
                  residency: str = "spill",
                  high_degree_fraction: float = 0.1, **kw: Any) -> "Scenario":
        """Sampled-minibatch scenario: fanout episodes as schedule tiles."""
        comp = (None if widths is None else Composition(
            widths=tuple(widths), residency=residency))
        graph = {"kind": "minibatch", "dataset": dataset,
                 "params": dict(params or {}), "batch_nodes": batch_nodes,
                 "fanout": tuple(fanout), "n_batches": n_batches,
                 "seed": seed, "N": N, "T": T,
                 "high_degree_fraction": high_degree_fraction}
        return cls(dataflow=dataflow, graph=graph, composition=comp, **kw)

    # -- structure --------------------------------------------------------
    def _graph_key(self) -> tuple:
        """Canonical hashable view of the graph mapping (nested params)."""
        return tuple(
            (k, tuple(sorted(v.items())) if isinstance(v, Mapping) else v)
            for k, v in sorted(self.graph.items()))

    def _optimize_key(self) -> Optional[str]:
        """Canonical (sorted-JSON) form of the normalized optimize block."""
        if self.optimize is None:
            return None
        return json.dumps(self.optimize, sort_keys=True,
                          separators=(",", ":"))

    def __hash__(self) -> int:
        expect = (None if self.expect is None
                  else tuple(sorted(self.expect.items())))
        return hash((self.dataflow, self._graph_key(),
                     tuple(sorted(self.hardware.items())), self.composition,
                     self.conformance, expect, self.label, self.workload,
                     self._optimize_key()))

    @property
    def graph_kind(self) -> str:
        """``"tile"``, ``"full"``, ``"trace"``, ``"hetero"``, or
        ``"minibatch"``."""
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
        elif self.graph_kind == "hetero":
            # The dataset+params+R fix the typed edge list, and
            # scalar-vs-per-relation N/T fix the stacked leaves' shapes;
            # tile capacity still stacks along the capacity axis, so one
            # group serves an R-relation batch regardless of R.
            key += (self.graph["dataset"],
                    tuple(sorted(self.graph["params"].items())),
                    self.graph["n_relations"],
                    isinstance(self.graph["N"], tuple),
                    isinstance(self.graph["T"], tuple))
        elif self.graph_kind == "minibatch":
            # The whole sampling protocol is structural: it fixes the
            # episode schedule (its rng stream included), so only N/T and
            # hardware values batch.
            key += (self.graph["dataset"],
                    tuple(sorted(self.graph["params"].items())),
                    self.graph["batch_nodes"], self.graph["fanout"],
                    self.graph["n_batches"], self.graph["seed"])
        if self.optimize is not None:
            # A search request never batches with plain scenarios (the
            # planner routes it through the tuner); two searches share a
            # key only for identical canonical blocks.
            key += ("optimize", self._optimize_key())
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
        if self.conformance:
            out["conformance"] = True
        if self.expect is not None:
            out["expect"] = dict(self.expect)
        if self.label:
            out["label"] = self.label
        if self.workload:
            out["workload"] = self.workload
        if self.optimize is not None:
            # A deep copy through JSON: the caller must not alias our state.
            out["optimize"] = json.loads(self._optimize_key())
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


def _trusted_tile(dataflow: str, graph: Mapping[str, float],
                  hardware: Mapping[str, float], label: str = "",
                  workload: str = "") -> Scenario:
    """A plain tile Scenario built without validation (the figure
    templates' hot path, one object per grid cell).

    Only for values the caller already normalized: finite float64s, exactly
    the tile field set, no composition.  Everything else goes through the
    public constructors.
    """
    s = object.__new__(Scenario)
    set_ = object.__setattr__
    set_(s, "dataflow", dataflow)
    set_(s, "graph", dict(graph))
    set_(s, "hardware", dict(hardware))
    set_(s, "composition", None)
    set_(s, "conformance", False)
    set_(s, "expect", None)
    set_(s, "label", label)
    set_(s, "workload", workload)
    set_(s, "optimize", None)
    set_(s, "_graph_kind", "tile")
    return s


def scenarios_to_dicts(scenarios: Sequence[Scenario]) -> dict:
    return {"scenarios": [s.to_dict() for s in scenarios]}


def dump_scenarios(scenarios: Sequence[Scenario], path: str) -> None:
    """Write a scenario batch file: ``{"scenarios": [...]}``."""
    with open(path, "w") as f:
        json.dump(scenarios_to_dicts(scenarios), f, indent=2, sort_keys=True)
        f.write("\n")


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
