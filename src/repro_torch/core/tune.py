"""Design-space tuner over the closed-form movement models (a copy of the
reference's ``repro/core/tune.py``, with the probes' device).

Given a workload scenario and an SRAM budget, the tuner finds the
movement-minimizing ``(dataflow, tile capacity, inter-layer residency, halo
policy)`` configuration, and the movement-vs-SRAM Pareto frontier when the
budget is left open.

* Every candidate is a plain concrete :class:`~repro_torch.api.scenario.
  Scenario`, so one ``evaluate_scenarios`` call per probe batch evaluates
  the candidates sharing a plan key in one stacked closed-form call: a
  capacity sweep is one group per (dataflow, residency, halo) cell.
* Trace and hetero candidates share the dataset's one factorization through
  the resolved-trace LRU and the disk cache, and every capacity's schedule
  is counted once by kernel K4 on ``device`` (CUDA unless ``device="cpu"``,
  where K4's plain version runs).  A multi-capacity tune performs exactly
  one factorization.
* Spaces of up to ``max_exhaustive`` candidates (default 4096) are swept
  exhaustively, so the tuner is the brute-force oracle, bit-identical to an
  ``np.argmin`` over the cross-product.  Larger spaces run coordinate
  descent with a deterministic restart schedule; every probe is memoized
  and the answer is the best feasible point seen.

Feasibility is the closed-form SRAM working set
(:func:`repro_torch.core.compose.tile_working_set_bits`).  A budget below
every candidate's working set raises :class:`InfeasibleBudgetError`, a
``ValueError``, so the CLI exits 2 with a one-line message.

The module imports only the standard library and numpy, so the scenario
layer can normalize ``{"optimize": ...}`` blocks without the engine; the
registry, compose and planner are imported inside :func:`tune_scenario`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "OBJECTIVE_METRICS",
    "SPACE_AXES",
    "TUNE_METHODS",
    "DEFAULT_MAX_EXHAUSTIVE",
    "DEFAULT_RESTARTS",
    "InfeasibleBudgetError",
    "TunePoint",
    "TuneResult",
    "normalize_optimize",
    "tune_scenario",
]

#: Scalar objectives a tune may minimize (or weight in a mapping).
OBJECTIVE_METRICS = ("movement", "offchip", "iterations")
#: Searchable axes of the ``optimize.space`` block.
SPACE_AXES = ("dataflow", "tile_vertices", "n_tiles", "residency",
              "halo_dedup")
TUNE_METHODS = ("auto", "exhaustive", "coordinate")
#: ``method="auto"`` sweeps exhaustively up to this many candidates.
DEFAULT_MAX_EXHAUSTIVE = 4096
#: Default coordinate-descent restart count.
DEFAULT_RESTARTS = 3

_RESIDENCIES = ("spill", "resident")
_BUDGET_KEYS = ("sram_bits", "sram_bytes")
#: ``TuneResult.to_dict`` embeds the full evaluated point list only up
#: to this size (the frontier and the winner are always embedded).
_POINTS_EMBED_LIMIT = 512


class InfeasibleBudgetError(ValueError):
    """No point in the search space fits the SRAM budget.

    A ``ValueError`` subclass, so the CLI's schema handling (exit 2, one
    line) applies, but typed so callers can tell "your budget is too small"
    from "your scenario is malformed".
    """


# ---------------------------------------------------------------------------
# {"optimize": ...} schema normalization (pure data -> pure data).  It lives
# beside the engine that interprets it; Scenario.__post_init__ calls
# normalize_optimize and stores the canonical form.
# ---------------------------------------------------------------------------

def _finite_number(value: Any, what: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"{what} must be a plain number, got {value!r} "
                        f"of type {type(value).__name__}")
    out = float(value)
    if not math.isfinite(out):
        raise ValueError(f"{what} must be finite, got {value!r}")
    return out


def _value_list(value: Any, what: str) -> list:
    if isinstance(value, (str, bytes)) or not isinstance(value, Sequence):
        raise TypeError(f"{what} must be a list of values, got {value!r}")
    out = list(value)
    if not out:
        raise ValueError(f"{what} must not be empty: an empty axis makes "
                         "the search space empty")
    return out


def _normalized_objective(obj: Any):
    if isinstance(obj, str):
        if obj not in OBJECTIVE_METRICS:
            raise ValueError(
                f"unknown objective {obj!r}; expected one of "
                f"{list(OBJECTIVE_METRICS)} or a {{metric: weight}} mapping")
        return obj
    if isinstance(obj, Mapping):
        if not obj:
            raise ValueError("empty objective mapping: give at least one "
                             f"of {list(OBJECTIVE_METRICS)} with a weight")
        unknown = set(map(str, obj)) - set(OBJECTIVE_METRICS)
        if unknown:
            raise ValueError(
                f"unknown objective metric(s) {sorted(unknown)}; "
                f"expected a subset of {list(OBJECTIVE_METRICS)}")
        weights = {}
        for key in OBJECTIVE_METRICS:
            if key in obj:
                v = obj[key]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise TypeError(f"objective weight for {key!r} must be "
                                    f"a plain number, got {v!r}")
                w = float(v)
                if not math.isfinite(w):
                    raise ValueError(f"non-finite objective weight for "
                                     f"{key!r}: {v!r}")
                weights[key] = w
        return weights
    raise TypeError(f"optimize.objective must be a metric name or a "
                    f"{{metric: weight}} mapping, got {obj!r}")


def _normalized_budget(budget: Any) -> Optional[dict]:
    if budget is None:
        return None
    if not isinstance(budget, Mapping):
        raise TypeError(f"optimize.budget must be a mapping like "
                        f"{{'sram_bits': ...}}, got {budget!r}")
    unknown = set(map(str, budget)) - set(_BUDGET_KEYS)
    if unknown:
        raise ValueError(f"unknown budget key(s) {sorted(unknown)}; "
                         f"expected one of {list(_BUDGET_KEYS)}")
    if len(budget) != 1:
        raise ValueError("optimize.budget must give exactly one of "
                         f"{list(_BUDGET_KEYS)}")
    key, value = next(iter(budget.items()))
    bits = _finite_number(value, f"optimize.budget.{key}")
    if key == "sram_bytes":
        bits *= 8.0
    if bits < 0:
        raise ValueError(
            f"negative SRAM budget ({key}={value!r}): a budget is an "
            "on-chip capacity and must be >= 0")
    return {"sram_bits": bits}


def _normalized_space(space: Any) -> dict:
    if not isinstance(space, Mapping):
        raise TypeError(f"optimize.space must be a mapping of axes, "
                        f"got {space!r}")
    unknown = set(map(str, space)) - set(SPACE_AXES)
    if unknown:
        raise ValueError(f"unknown optimize space axis(es) {sorted(unknown)}; "
                         f"searchable axes: {list(SPACE_AXES)}")
    if "tile_vertices" in space and "n_tiles" in space:
        raise ValueError(
            "give one of space.tile_vertices / space.n_tiles, not both "
            "(n_tiles converts to a capacity via ceil(V / n_tiles))")
    out: dict[str, Any] = {}
    if "dataflow" in space:
        v = space["dataflow"]
        if v == "all":
            out["dataflow"] = "all"
        elif isinstance(v, str):
            raise ValueError(f"space.dataflow must be 'all' or a list of "
                             f"registered names, got {v!r}")
        else:
            names = _value_list(v, "space.dataflow")
            seen: list[str] = []
            for name in names:
                if not isinstance(name, str) or not name:
                    raise ValueError(f"space.dataflow entries must be "
                                     f"non-empty names, got {name!r}")
                if name not in seen:
                    seen.append(name)
            out["dataflow"] = seen
    if "tile_vertices" in space:
        caps = _value_list(space["tile_vertices"], "space.tile_vertices")
        vals = []
        for c in caps:
            cv = _finite_number(c, "space.tile_vertices entry")
            if cv < 1:
                raise ValueError(f"space.tile_vertices entries must be "
                                 f">= 1, got {c!r}")
            vals.append(cv)
        out["tile_vertices"] = vals
    if "n_tiles" in space:
        tiles = _value_list(space["n_tiles"], "space.n_tiles")
        vals = []
        for t in tiles:
            tv = _finite_number(t, "space.n_tiles entry")
            if tv < 1 or tv != int(tv):
                raise ValueError(f"space.n_tiles entries must be whole "
                                 f"numbers >= 1, got {t!r}")
            vals.append(int(tv))
        out["n_tiles"] = vals
    if "residency" in space:
        res = _value_list(space["residency"], "space.residency")
        seen = []
        for r in res:
            if r not in _RESIDENCIES:
                raise ValueError(f"unknown residency {r!r} in "
                                 f"space.residency; expected a subset of "
                                 f"{list(_RESIDENCIES)}")
            if r not in seen:
                seen.append(r)
        out["residency"] = seen
    if "halo_dedup" in space:
        halos = _value_list(space["halo_dedup"], "space.halo_dedup")
        vals = []
        for h in halos:
            hv = _finite_number(h, "space.halo_dedup entry")
            if hv < 1.0:
                raise ValueError(f"space.halo_dedup entries must be >= 1 "
                                 f"(they divide halo traffic), got {h!r}")
            vals.append(hv)
        out["halo_dedup"] = vals
    return out


def normalize_optimize(data: Any) -> dict:
    """Validate an ``{"optimize": ...}`` block into its canonical form.

    Pure data in, pure data out (JSON-able, idempotent): the scenario
    layer stores the result, hashes/plan-keys its sorted-JSON dump, and
    round-trips it through ``to_dict``/``from_dict`` unchanged.  Raises
    ``ValueError``/``TypeError`` with a one-line message on any schema
    violation (unknown axis, negative budget, non-finite objective
    weight, ...), which the CLI maps to exit code 2.
    """
    if not isinstance(data, Mapping):
        raise TypeError(f"optimize must be a mapping, got "
                        f"{type(data).__name__}")
    known = {"objective", "budget", "space", "method", "max_exhaustive",
             "restarts"}
    unknown = set(map(str, data)) - known
    if unknown:
        raise ValueError(f"unknown optimize key(s) {sorted(unknown)}; "
                         f"expected a subset of {sorted(known)}")
    method = data.get("method", "auto")
    if method not in TUNE_METHODS:
        raise ValueError(f"unknown optimize method {method!r}; expected "
                         f"one of {list(TUNE_METHODS)}")
    max_exh = _finite_number(data.get("max_exhaustive",
                                      DEFAULT_MAX_EXHAUSTIVE),
                             "optimize.max_exhaustive")
    if max_exh < 1 or max_exh != int(max_exh):
        raise ValueError(f"optimize.max_exhaustive must be a whole number "
                         f">= 1, got {data.get('max_exhaustive')!r}")
    restarts = _finite_number(data.get("restarts", DEFAULT_RESTARTS),
                              "optimize.restarts")
    if restarts < 1 or restarts != int(restarts):
        raise ValueError(f"optimize.restarts must be a whole number >= 1, "
                         f"got {data.get('restarts')!r}")
    return {
        "objective": _normalized_objective(data.get("objective", "movement")),
        "budget": _normalized_budget(data.get("budget")),
        "space": _normalized_space(data.get("space", {})),
        "method": method,
        "max_exhaustive": int(max_exh),
        "restarts": int(restarts),
    }


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TunePoint:
    """One evaluated configuration of the search space.

    ``index`` is the configuration's position in the canonical
    cross-product enumeration (dataflow-major, capacity innermost) —
    the tie-break order shared with the exhaustive oracle.
    """

    index: int
    dataflow: str
    tile_vertices: float
    residency: Any  # one policy name, or a per-relation tuple
    halo_dedup: float
    objective: float
    sram_bits: float
    total_bits: float
    total_iterations: float
    n_tiles: Optional[float]
    feasible: bool

    def to_dict(self) -> dict:
        out = {
            "index": self.index,
            "dataflow": self.dataflow,
            "tile_vertices": self.tile_vertices,
            "residency": (list(self.residency)
                          if isinstance(self.residency, tuple)
                          else self.residency),
            "halo_dedup": self.halo_dedup,
            "objective": self.objective,
            "sram_bits": self.sram_bits,
            "total_bits": self.total_bits,
            "total_iterations": self.total_iterations,
            "feasible": self.feasible,
        }
        if self.n_tiles is not None:
            out["n_tiles"] = self.n_tiles
        return out


@dataclass(frozen=True)
class TuneResult:
    """A finished tune: the winner, the frontier, and the search record.

    ``best_result`` is the winner's full planner
    :class:`~repro_torch.api.planner.ScenarioResult` (breakdown and all), so
    the planner can surface a tuned scenario exactly like a concrete
    one.  ``points`` holds every *distinct* configuration evaluated, in
    canonical index order (for an exhaustive run that is the whole
    space); ``frontier`` is the movement-vs-SRAM Pareto frontier over
    the feasible evaluated points (sram ascending, objective strictly
    descending — non-domination is property-tested).
    """

    scenario: Any
    method: str
    objective: Any
    budget_bits: Optional[float]
    axes: Mapping[str, tuple]
    best: TunePoint
    best_result: Any
    points: tuple[TunePoint, ...]
    frontier: tuple[TunePoint, ...]
    n_candidates: int
    n_evaluated: int
    n_feasible: int
    n_groups: int

    def to_dict(self) -> dict:
        out = {
            "method": self.method,
            "objective": self.objective,
            "budget": (None if self.budget_bits is None
                       else {"sram_bits": self.budget_bits}),
            "axes": {k: list(v) for k, v in self.axes.items()},
            "n_candidates": self.n_candidates,
            "n_evaluated": self.n_evaluated,
            "n_feasible": self.n_feasible,
            "n_groups": self.n_groups,
            "best": self.best.to_dict(),
            "frontier": [p.to_dict() for p in self.frontier],
        }
        if self.best_result is not None and self.best_result.n_tiles is not None:
            out["best"]["n_tiles"] = float(self.best_result.n_tiles)
        if self.n_evaluated <= _POINTS_EMBED_LIMIT:
            out["points"] = [p.to_dict() for p in self.points]
        return out


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _objective_value(objective, result) -> float:
    vals = {"movement": result.total_bits,
            "offchip": result.offchip_bits,
            "iterations": result.total_iterations}
    if isinstance(objective, str):
        out = float(vals[objective])
    else:
        out = float(sum(w * vals[k] for k, w in objective.items()))
    if not math.isfinite(out):
        raise ValueError(f"objective evaluated to a non-finite value "
                         f"({out!r}) — the closed forms should never do "
                         "this; check the objective weights")
    return out


def _pareto_frontier(points: Sequence[TunePoint]) -> tuple[TunePoint, ...]:
    """Non-dominated (sram_bits, objective) subset of the feasible points.

    Sort by (sram, objective, index) and keep the strict prefix-minimum
    of the objective: every kept pair then has strictly larger sram AND
    strictly smaller objective than its predecessor, so no kept point
    dominates another, and every dropped point is dominated by a kept
    one at equal-or-smaller sram.
    """
    pts = sorted((p for p in points if p.feasible),
                 key=lambda p: (p.sram_bits, p.objective, p.index))
    out: list[TunePoint] = []
    best = math.inf
    for p in pts:
        if p.objective < best:
            out.append(p)
            best = p.objective
    return tuple(out)


def tune_scenario(scenario, *, device=None) -> TuneResult:
    """Run the search for one ``{"optimize": ...}`` scenario.

    Resolves the space axes against the base scenario (missing axes pin
    to the scenario's own value; ``dataflow: "all"`` expands to the
    registry), enumerates the cross-product in canonical order, and
    either sweeps it exhaustively (one ``evaluate_scenarios`` call — the
    planner batches capacities per (dataflow, residency, halo) group) or
    runs memoized coordinate descent from a deterministic restart
    schedule.  Returns the arg-min feasible configuration, bit-identical
    on exhaustive runs to ``np.argmin`` over the same enumeration.

    Every probe batch, and the dataset resolve, runs on ``device``: trace
    and hetero candidates count their schedules with K4 there (CUDA unless
    ``device="cpu"``; without a card the call raises).
    """
    opt = getattr(scenario, "optimize", None)
    if opt is None:
        raise ValueError("tune_scenario needs a scenario with an "
                         "{'optimize': ...} block; plain scenarios go "
                         "through evaluate_scenarios directly")
    if getattr(scenario, "graph_kind", None) == "minibatch":
        # The scenario layer rejects this combination at construction;
        # keep the engine-side check so a hand-built object fails the
        # same way instead of deep in the search.
        raise ValueError(
            "minibatch scenarios have no searchable tiling: the sampling "
            "episode (batch_nodes/fanout) fixes the schedule, so there is "
            "no tile_vertices axis to optimize")
    # Lazy imports: this module stays import-light for the scenario layer,
    # and importing the planner at module level would be circular.
    from ..api.planner import evaluate_scenarios
    from ..api.scenario import Composition
    from . import registry
    from .compose import tile_working_set_bits

    comp = scenario.composition
    kind = scenario.graph_kind
    space = opt["space"]

    n_relations = 1
    if kind in ("trace", "hetero"):
        from .trace import resolve_trace_dataset
        params = dict(scenario.graph["params"])
        if kind == "hetero":
            n_relations = int(scenario.graph["n_relations"])
            params["n_relations"] = n_relations
        trace = resolve_trace_dataset(scenario.graph["dataset"], params)
        V = float(trace.n_nodes)
    else:
        V = float(scenario.graph["V"])

    # -- resolve axes ------------------------------------------------------
    dataflows = space.get("dataflow")
    if dataflows == "all":
        dataflows = registry.names()
    elif dataflows is None:
        dataflows = (scenario.dataflow,)
    dataflows = tuple(dataflows)
    for name in dataflows:
        registry.get(name)  # unknown dataflow fails now, not mid-search
    res_axis = space.get("residency")
    if res_axis is not None and kind == "hetero" and n_relations > 1:
        # Per-relation residency search: the policy axis expands to
        # the cross-product of per-relation assignments.  Homogeneous
        # tuples are kept as tuples; the planner's plan key treats the
        # tuple arity structurally, so each assignment still lands in one
        # broadcast group per (dataflow, residency).
        expanded = len(res_axis) ** n_relations
        if expanded > DEFAULT_MAX_EXHAUSTIVE:
            raise ValueError(
                f"per-relation residency search is "
                f"{len(res_axis)}^{n_relations} = {expanded} assignments, "
                f"above the {DEFAULT_MAX_EXHAUSTIVE}-point expansion cap; "
                "pin composition.residency or reduce n_relations")
        import itertools
        residencies = tuple(itertools.product(res_axis,
                                              repeat=n_relations))
    else:
        residencies = tuple(res_axis or (comp.residency,))
    halos = tuple(space.get("halo_dedup") or (comp.halo_dedup,))
    if "tile_vertices" in space:
        caps = tuple(space["tile_vertices"])
    elif "n_tiles" in space:
        caps = tuple(float(math.ceil(V / nt)) for nt in space["n_tiles"])
    else:
        caps = (float(comp.tile_vertices),)
    if kind in ("trace", "hetero"):
        for c in caps:
            if c != int(c):
                raise ValueError(f"{kind} tile capacities must be whole "
                                 f"numbers >= 1, got {c!r}")
    axes = {"dataflow": dataflows, "residency": residencies,
            "halo_dedup": halos, "tile_vertices": caps}

    objective = opt["objective"]
    budget = opt["budget"]
    budget_bits = None if budget is None else float(budget["sram_bits"])
    widths = (comp.widths if comp.widths is not None
              else (scenario.graph["N"], scenario.graph["T"]))
    sigma = {}
    for name in dataflows:
        hw = registry.get(name).hw_factory()
        sigma[name] = float(scenario.hardware.get("sigma", hw.sigma))

    def working_set(cap, sig, res, hd) -> float:
        """Feasibility SRAM model for one candidate.

        Homogeneous scenarios call :func:`tile_working_set_bits`
        directly.  Hetero scenarios sum it over relations: every
        relation's weights are resident for the pass and each holds its
        own per-relation activation slice, under its own residency
        policy when ``res`` is a per-relation tuple.
        """
        if kind != "hetero":
            return float(tile_working_set_bits(
                cap, V=V, widths=widths, sigma=sig, residency=res,
                halo_dedup=hd))
        total = 0.0
        for r in range(n_relations):
            w_r = tuple(w[r] if isinstance(w, (tuple, list)) else w
                        for w in widths)
            res_r = res[r] if isinstance(res, (tuple, list)) else res
            total += float(tile_working_set_bits(
                cap, V=V, widths=w_r, sigma=sig, residency=res_r,
                halo_dedup=hd))
        return total

    # -- canonical enumeration (the oracle's order) ------------------------
    # A candidate is (dataflow, tile_vertices, residency, halo_dedup);
    # capacity is innermost so one (dataflow, residency, halo) run is one
    # contiguous capacity-batched planner group.
    def cand_index(c) -> int:
        return ((dataflows.index(c[0]) * len(residencies)
                 + residencies.index(c[2])) * len(halos)
                + halos.index(c[3])) * len(caps) + caps.index(c[1])

    all_candidates = [(df, cap, res, hd)
                      for df in dataflows
                      for res in residencies
                      for hd in halos
                      for cap in caps]
    n_candidates = len(all_candidates)
    method = opt["method"]
    if method == "auto":
        method = ("exhaustive" if n_candidates <= opt["max_exhaustive"]
                  else "coordinate")

    def candidate_scenario(c):
        df, cap, res, hd = c
        return scenario.replace(
            dataflow=df,
            composition=Composition(widths=comp.widths, residency=res,
                                    tile_vertices=cap, halo_dedup=hd),
            optimize=None, expect=None, conformance=False,
            label=(f"{scenario.label or 'tune'}"
                   f"/{df}/tv{cap:g}/"
                   f"{res if isinstance(res, str) else '+'.join(res)}/"
                   f"hd{hd:g}"))

    evaluated: dict[tuple, TunePoint] = {}
    results: dict[tuple, Any] = {}
    n_groups = 0

    def eval_candidates(cands) -> None:
        nonlocal n_groups
        todo = [c for c in dict.fromkeys(cands) if c not in evaluated]
        if not todo:
            return
        batch = evaluate_scenarios([candidate_scenario(c) for c in todo],
                                   device=device)
        n_groups += batch.n_evaluations
        for c, r in zip(todo, batch.results):
            sram = working_set(c[1], sigma[c[0]], c[2], c[3])
            evaluated[c] = TunePoint(
                index=cand_index(c), dataflow=c[0],
                tile_vertices=float(c[1]), residency=c[2],
                halo_dedup=float(c[3]),
                objective=_objective_value(objective, r),
                sram_bits=sram,
                total_bits=r.total_bits,
                total_iterations=r.total_iterations,
                n_tiles=r.n_tiles,
                feasible=(budget_bits is None or sram <= budget_bits))
            results[c] = r

    # -- search ------------------------------------------------------------
    if method == "exhaustive":
        # ONE planner call for the whole space: the oracle path.
        eval_candidates(all_candidates)
        obj = np.array([evaluated[c].objective for c in all_candidates])
        feas = np.array([evaluated[c].feasible for c in all_candidates])
        if not feas.any():
            _raise_infeasible(budget_bits, evaluated)
        best_c = all_candidates[int(np.argmin(np.where(feas, obj, np.inf)))]
    else:
        axis_vals: list[tuple] = [dataflows, residencies, halos, caps]
        restarts = opt["restarts"]
        for r in range(restarts):
            # Deterministic restart schedule: restart r starts at the
            # evenly spaced position along each axis (first corner, ...,
            # last corner), so restarts cover the space without RNG.
            idx = [((len(vals) - 1) * r) // max(restarts - 1, 1)
                   for vals in axis_vals]
            cur = (axis_vals[0][idx[0]], axis_vals[3][idx[3]],
                   axis_vals[1][idx[1]], axis_vals[2][idx[2]])
            eval_candidates([cur])
            p = evaluated[cur]
            cur_obj = p.objective if p.feasible else math.inf
            for _ in range(16):  # bounded descent cycles
                moved = False
                for a, vals in enumerate(axis_vals):
                    if len(vals) == 1:
                        continue
                    sweeps = []
                    for v in vals:
                        c = list((cur[0], cur[2], cur[3], cur[1]))
                        c[a] = v
                        sweeps.append((c[0], c[3], c[1], c[2]))
                    eval_candidates(sweeps)
                    move_to = None
                    move_obj = cur_obj
                    for c in sweeps:
                        pt = evaluated[c]
                        if pt.feasible and pt.objective < move_obj:
                            move_to, move_obj = c, pt.objective
                    if move_to is not None:
                        cur, cur_obj, moved = move_to, move_obj, True
                if not moved:
                    break
        feasible_pts = [p for p in evaluated.values() if p.feasible]
        if not feasible_pts:
            _raise_infeasible(budget_bits, evaluated)
        best_p = min(feasible_pts, key=lambda p: (p.objective, p.index))
        best_c = (best_p.dataflow, best_p.tile_vertices, best_p.residency,
                  best_p.halo_dedup)

    points = tuple(sorted(evaluated.values(), key=lambda p: p.index))
    return TuneResult(
        scenario=scenario,
        method=method,
        objective=objective,
        budget_bits=budget_bits,
        axes=axes,
        best=evaluated[best_c],
        best_result=results[best_c],
        points=points,
        frontier=_pareto_frontier(points),
        n_candidates=n_candidates,
        n_evaluated=len(evaluated),
        n_feasible=sum(1 for p in points if p.feasible),
        n_groups=n_groups,
    )


def _raise_infeasible(budget_bits, evaluated) -> None:
    min_sram = min(p.sram_bits for p in evaluated.values())
    raise InfeasibleBudgetError(
        f"SRAM budget {budget_bits:.6g} bits is below every explored "
        f"configuration's working set (minimum {min_sram:.6g} bits over "
        f"{len(evaluated)} candidates); relax the budget or widen the "
        "search space")
