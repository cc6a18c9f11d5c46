"""Batch planner: evaluate scenario batches with one broadcast call per plan
(a copy of the reference's ``repro/api/planner.py``).

``evaluate_scenarios`` groups scenarios by :meth:`Scenario.plan_key` and
evaluates each group in one closed-form call: every numeric leaf (graph
fields, hardware overrides, layer widths, tile capacities) is stacked along
a leading batch axis.  The closed forms are elementwise float64 algebra, so
the stacked evaluation is bit-identical to evaluating each scenario alone.

Two things run on ``device`` (CUDA unless ``device="cpu"``): a trace or
hetero group's exact schedules come from kernel K4 (for a hetero group, one
:class:`~repro_torch.core.compose.RelationalGraphModel` call covers every
relation), and a ``conformance=True`` scenario's check holds its
dataflow's kernels to their closed form and runs K1, K2 and K3 against the
fp32 oracle.  A minibatch group's episode schedule is sampled on the host.
A scenario with an ``optimize`` block goes through the tuner
(:func:`repro_torch.core.tune.tune_scenario`) on the same ``device``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

from ..core import registry
from ..core.compose import (FullGraphParams, MultiLayerModel,
                            RelationalGraphModel, TiledGraphModel)
from ..core.notation import GraphTileParams
from ..core.terms import ModelOutput
from ..core.trace import TypedGraphTrace, resolve_trace_dataset
from .scenario import Scenario, TILE_GRAPH_FIELDS

__all__ = [
    "EXPECT_REL_TOL",
    "ScenarioResult",
    "GroupResult",
    "BatchResult",
    "coalesce_scenarios",
    "evaluate_scenario",
    "evaluate_scenarios",
    "evaluate_groups",
]

#: Relative tolerance for ``Scenario.expect`` pins.  The planner is
#: bit-identical, but pinned values travel through JSON decimal repr.
EXPECT_REL_TOL = 1e-12


@dataclass(frozen=True)
class ScenarioResult:
    """One scenario's evaluated movement totals and per-term breakdown."""

    scenario: Scenario
    total_bits: float
    total_iterations: float
    offchip_bits: float
    cache_bits: float
    onchip_bits: float
    breakdown: Mapping[str, float]
    iteration_breakdown: Mapping[str, float]
    n_tiles: Optional[float] = None
    conformance: Optional[Mapping[str, Any]] = None
    meta: Mapping[str, Any] = field(default_factory=dict)

    @property
    def expect_ok(self) -> Optional[bool]:
        """None when the scenario pins nothing; else whether pins hold."""
        if self.scenario.expect is None:
            return None
        return not self.expect_failures()

    def expect_failures(self) -> list[str]:
        fails = []
        if self.scenario.expect is not None:
            got: dict[str, Any] = {"total_bits": self.total_bits,
                                   "total_iterations": self.total_iterations}
            tune = (self.meta or {}).get("tune")
            if tune is not None:
                got["objective"] = tune["best"]["objective"]
                got["best_dataflow"] = tune["best"]["dataflow"]
                got["best_tile_vertices"] = tune["best"]["tile_vertices"]
            for key, want in self.scenario.expect.items():
                have = got.get(key)
                if isinstance(want, str) or isinstance(have, str):
                    if have != want:
                        fails.append(f"{key}: expected {want!r}, got {have!r}")
                elif have is None or not np.isclose(have, want,
                                                    rtol=EXPECT_REL_TOL,
                                                    atol=0.0):
                    fails.append(f"{key}: expected {want!r}, got {have!r}")
        return fails

    def to_dict(self) -> dict:
        out = {
            "scenario": self.scenario.to_dict(),
            "total_bits": self.total_bits,
            "total_iterations": self.total_iterations,
            "offchip_bits": self.offchip_bits,
            "cache_bits": self.cache_bits,
            "onchip_bits": self.onchip_bits,
            "breakdown": dict(self.breakdown),
            "iteration_breakdown": dict(self.iteration_breakdown),
        }
        if self.n_tiles is not None:
            out["n_tiles"] = self.n_tiles
        if self.scenario.expect is not None:
            out["expect_ok"] = self.expect_ok
        if self.conformance is not None:
            out["conformance"] = dict(self.conformance)
        tune = (self.meta or {}).get("tune")
        if tune is not None:
            out["tune"] = tune
        serve = (self.meta or {}).get("serve")
        if serve is not None:
            out["serve"] = dict(serve)
        return out


@dataclass(frozen=True)
class GroupResult:
    """One broadcast evaluation: the scenarios it covered and the raw output.

    ``output`` is the stacked :class:`~repro_torch.core.terms.ModelOutput`
    whose term arrays carry the batch axis; ``indices`` map batch positions
    back to the input scenario order.
    """

    dataflow: str
    plan_key: tuple
    indices: tuple[int, ...]
    output: ModelOutput


@dataclass(frozen=True)
class BatchResult:
    """Results in input order plus the evaluation plan that produced them."""

    results: tuple[ScenarioResult, ...]
    groups: tuple[GroupResult, ...]

    @property
    def n_evaluations(self) -> int:
        """Broadcast closed-form calls performed (== number of groups)."""
        return len(self.groups)

    def evaluations_per_dataflow(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for g in self.groups:
            counts[g.dataflow] = counts.get(g.dataflow, 0) + 1
        return counts

    def expect_failures(self) -> list[tuple[Scenario, list[str]]]:
        out = []
        for r in self.results:
            fails = r.expect_failures()
            if fails:
                out.append((r.scenario, fails))
        return out

    def rows(self) -> list[dict]:
        """Flat records (one per scenario) for CSV/JSON dumps."""
        return [{
            "label": r.scenario.label, "workload": r.scenario.workload,
            "dataflow": r.scenario.dataflow,
            "graph_kind": r.scenario.graph_kind,
            "total_bits": r.total_bits,
            "total_iterations": r.total_iterations,
            "offchip_bits": r.offchip_bits,
            "cache_bits": r.cache_bits,
            "onchip_bits": r.onchip_bits,
        } for r in self.results]

    def to_dict(self) -> dict:
        return {
            "n_scenarios": len(self.results),
            "n_evaluations": self.n_evaluations,
            "evaluations_per_dataflow": self.evaluations_per_dataflow(),
            "results": [r.to_dict() for r in self.results],
        }


def coalesce_scenarios(scenarios: Sequence[Scenario]
                       ) -> tuple[list[Scenario], tuple[int, ...]]:
    """Cross-request dedup: ``(distinct, backmap)`` over a flat batch.

    ``distinct`` holds the unique scenarios in first-seen order and
    ``backmap[i]`` is the position of ``scenarios[i]`` inside it, so a
    caller can evaluate ``distinct`` once and scatter results back with
    ``[results[j] for j in backmap]``.  Equality is full scenario equality,
    finer than :meth:`Scenario.plan_key`: equal-plan-key scenarios with
    different numeric leaves stay distinct here and share one broadcast
    group later.
    """
    distinct: list[Scenario] = []
    index: dict[Scenario, int] = {}
    backmap: list[int] = []
    for s in _checked(scenarios):
        j = index.get(s)
        if j is None:
            j = len(distinct)
            index[s] = j
            distinct.append(s)
        backmap.append(j)
    return distinct, tuple(backmap)


def _checked(scenarios: Sequence[Scenario]) -> list[Scenario]:
    scenarios = list(scenarios)
    for i, s in enumerate(scenarios):
        if not isinstance(s, Scenario):
            raise TypeError(f"scenarios[{i}] is {type(s).__name__}, "
                            "expected Scenario")
    return scenarios


def _stack(values: Iterable[float]) -> np.ndarray:
    return np.asarray(list(values), dtype=np.float64)


def _group_hw(spec, scenarios: Sequence[Scenario]):
    """Default hardware with the group's overrides stacked per field."""
    keys = sorted(scenarios[0].hardware)
    if not keys:
        return None
    hw = spec.hw_factory()
    valid = {f.name for f in dataclasses.fields(hw)}
    unknown = set(keys) - valid
    if unknown:
        raise ValueError(
            f"unknown hardware override(s) {sorted(unknown)} for dataflow "
            f"{spec.name!r}; valid fields: {sorted(valid)}")
    return hw.replace(**{k: _stack(s.hardware[k] for s in scenarios)
                         for k in keys})


def _stack_rel(values) -> np.ndarray:
    """Stack relation-carrying leaves of a hetero group, relation axis
    LAST: a per-relation list stacks to ``(B, R)``, a scalar leaf to
    ``(B, 1)`` so its batch axis cannot collide with the relation axis.
    Arity is uniform within a plan group (it is structural)."""
    vals = list(values)
    if vals and isinstance(vals[0], (tuple, list)):
        return np.asarray(vals, dtype=np.float64)
    return np.asarray(vals, dtype=np.float64)[:, None]


def _resolve_group_trace(first: Scenario):
    """Resolve the edge list behind a trace / hetero / minibatch group."""
    if first.graph_kind == "hetero":
        params = dict(first.graph["params"])
        params["n_relations"] = first.graph["n_relations"]
        trace = resolve_trace_dataset(first.graph["dataset"], params)
        if not isinstance(trace, TypedGraphTrace):
            raise TypeError(
                f"hetero scenario dataset {first.graph['dataset']!r} "
                f"resolved to {type(trace).__name__}, not a "
                "TypedGraphTrace; register a typed dataset (e.g. "
                "typed_power_law / typed_blocks / typed_cora) or use "
                "kind='trace' for homogeneous edge lists")
        if trace.n_relations != first.graph["n_relations"]:
            raise ValueError(
                f"dataset {first.graph['dataset']!r} produced "
                f"{trace.n_relations} relations but the scenario declares "
                f"n_relations={first.graph['n_relations']}")
        return trace
    return resolve_trace_dataset(first.graph["dataset"],
                                 first.graph["params"])


def _group_schedule(first: Scenario, trace):
    """The measured episode schedule of a minibatch group (cached per
    trace-backed CSR by minibatch_schedule's parameter-keyed cache)."""
    from ..data.sampler import csr_from_trace, minibatch_schedule

    g = getattr(trace, "_sampler_csr", None)
    if g is None:
        g = csr_from_trace(trace)
        trace._sampler_csr = g
    return minibatch_schedule(
        g, batch_nodes=first.graph["batch_nodes"],
        fanout=first.graph["fanout"], n_batches=first.graph["n_batches"],
        seed=first.graph["seed"])


def _group_model(spec, scenarios: Sequence[Scenario], trace=None,
                 schedule=None, device=None):
    """The (possibly composed) model shared by one plan group; ``trace``
    switches the tiled model onto the exact edge-list schedule, with tile
    capacities stacked along the capacity axis.  A typed trace (hetero
    group) builds ONE :class:`RelationalGraphModel` covering every
    relation; ``schedule`` (minibatch group) pins the episode schedule."""
    comp = scenarios[0].composition
    if scenarios[0].graph_kind == "hetero":
        widths = None
        if comp.widths is not None:
            widths = tuple(
                _stack_rel(s.composition.widths[i] for s in scenarios)
                for i in range(len(comp.widths)))
        return RelationalGraphModel(
            spec,
            tile_vertices=_stack(s.composition.tile_vertices
                                 for s in scenarios),
            trace=trace, widths=widths, residency=comp.residency,
            device=device)
    if comp is None:
        if schedule is not None:
            return TiledGraphModel(spec, schedule=schedule)
        return spec
    inner = spec
    if comp.widths is not None:
        widths = tuple(
            _stack(s.composition.widths[i] for s in scenarios)
            for i in range(len(comp.widths)))
        inner = MultiLayerModel(spec, widths, residency=comp.residency)
    if schedule is not None:
        return TiledGraphModel(inner, schedule=schedule)
    if comp.tile_vertices is None:
        return inner
    tile_vertices = _stack(s.composition.tile_vertices for s in scenarios)
    if trace is not None:
        return TiledGraphModel(inner, tile_vertices=tile_vertices,
                               trace=trace, device=device)
    return TiledGraphModel(inner, tile_vertices=tile_vertices,
                           halo_dedup=comp.halo_dedup)


def _group_graph(scenarios: Sequence[Scenario], trace=None, schedule=None):
    kind = scenarios[0].graph_kind
    if kind == "tile":
        return GraphTileParams(**{
            f: _stack(s.graph[f] for s in scenarios)
            for f in TILE_GRAPH_FIELDS})
    stack = _stack
    if kind in ("trace", "hetero"):
        # V/E are properties of the resolved edge list, shared across the
        # group (the dataset reference is part of the plan key).  Hetero
        # N/T may be per-relation vectors, stacked with the relation axis
        # LAST.
        V, E = float(trace.n_nodes), float(trace.n_edges)
        if kind == "hetero":
            stack = _stack_rel
    elif kind == "minibatch":
        # E is the measured total of sampled episode edges: the explicit
        # schedule is exact, so the declared graph must match it.
        V, E = float(trace.n_nodes), float(schedule.n_edges)
    else:
        V = _stack(s.graph["V"] for s in scenarios)
        E = _stack(s.graph["E"] for s in scenarios)
    return FullGraphParams(
        V=V, E=E,
        N=stack(s.graph["N"] for s in scenarios),
        T=stack(s.graph["T"] for s in scenarios),
        high_degree_fraction=_stack(s.graph["high_degree_fraction"]
                                    for s in scenarios),
    )


def _evaluate_group(scenarios: Sequence[Scenario], device) -> ModelOutput:
    first = scenarios[0]
    spec = registry.get(first.dataflow)
    trace = schedule = None
    if first.graph_kind in ("trace", "hetero", "minibatch"):
        trace = _resolve_group_trace(first)
    if first.graph_kind == "minibatch":
        schedule = _group_schedule(first, trace)
    model = _group_model(spec, scenarios, trace=trace, schedule=schedule,
                         device=device)
    graph = _group_graph(scenarios, trace=trace, schedule=schedule)
    hw = _group_hw(spec, scenarios)
    # THE one broadcast closed-form call for this group.
    return model.evaluate(graph, hw)


def _conformance_summary(dataflow: str, points=None, device=None) -> dict:
    """One-point measured-vs-modeled check of a dataflow's kernels.

    The harness holds the kernel analogue to the kernel spec it names
    (``spmm_tiled`` -> K1 against ``spmm_tiled_cta``, ``spmm_unfused`` ->
    K2 + K3 against ``spmm_unfused_cta``); then K1, K2 and K3 run once at
    each point through the counted ``ops`` wrappers against the fp32
    oracle: launched on CUDA, their plain versions on the CPU.
    """
    spec = registry.get(dataflow)
    if not spec.has_runnable:
        return {"checked": False, "ok": True,
                "reason": "no runnable kernel analogue (analytical-only)"}
    from ..core.conformance import (CHECK_POINT, NUMERICS_REL_TOL,
                                    conformance_records, verify_numerics)

    pts = points if points is not None else (CHECK_POINT,)
    n = n_bad = 0
    analytical = measured = 0.0
    for pt in pts:
        for rec in conformance_records(spec, pt, device=device):
            n += 1
            if not rec.ok:
                n_bad += 1
            if rec.movement == "hbm_total":
                analytical += rec.analytical_bytes
                measured += rec.measured_bytes
    numerics = max(verify_numerics(pt, device=device) for pt in pts)
    return {"checked": True,
            "ok": n_bad == 0 and numerics < NUMERICS_REL_TOL,
            "spec": spec.runnable_analogue().dataflow, "records": n, "violations": n_bad,
            "hbm_analytical_bytes": analytical,
            "hbm_measured_bytes": measured,
            "numerics_max_rel_err": numerics}


def evaluate_groups(scenarios: Sequence[Scenario], *,
                    device=None) -> tuple[GroupResult, ...]:
    """Group a batch by plan key and run one broadcast call per group.

    The sweep engine's path: it needs only each group's stacked
    :class:`~repro_torch.core.terms.ModelOutput`, so no per-scenario result
    is built.  Trace groups count their schedules with K4 on ``device``.
    Optimize scenarios are refused: they go through
    :func:`evaluate_scenarios`, which routes them to the tuner.
    """
    scenarios = _checked(scenarios)
    by_key: dict[tuple, list[int]] = {}
    for i, s in enumerate(scenarios):
        if s.optimize is not None:
            raise ValueError(
                f"scenarios[{i}] carries an optimize block; "
                "evaluate_groups evaluates concrete scenarios only; "
                "optimize scenarios go through evaluate_scenarios, which "
                "routes them to the tuner (repro_torch.core.tune)")
        by_key.setdefault(s.plan_key(), []).append(i)
    return tuple(
        GroupResult(dataflow=scenarios[idx[0]].dataflow, plan_key=key,
                    indices=tuple(idx),
                    output=_evaluate_group([scenarios[i] for i in idx],
                                           device))
        for key, idx in by_key.items())


def evaluate_scenarios(scenarios: Sequence[Scenario], *, device=None,
                       conformance_points=None) -> BatchResult:
    """Evaluate a scenario batch: one broadcast call per plan group.

    Results come back in input order.  Trace and hetero groups count their
    schedules with kernel K4 on ``device``, and ``conformance=True``
    scenarios run at most one conformance check per dataflow per batch
    there: CUDA unless ``device="cpu"``, and without a card the call
    raises rather than run on the CPU.

    Scenarios with an ``optimize`` block go through the tuner
    (:func:`repro_torch.core.tune.tune_scenario`, on ``device``) instead of
    a broadcast group: their slot holds the winning configuration's totals
    and breakdown, with the search record under ``meta["tune"]``.  The
    tuner's probe batches come back through this function, so its
    candidates still batch one stacked evaluation per plan group.
    """
    scenarios = _checked(scenarios)
    plain_idx = [i for i, s in enumerate(scenarios) if s.optimize is None]
    opt_idx = [i for i, s in enumerate(scenarios) if s.optimize is not None]
    # evaluate_groups indexes into the plain sublist; translate back to
    # input positions so GroupResult.indices keep their contract.
    groups = tuple(
        dataclasses.replace(g, indices=tuple(plain_idx[i] for i in g.indices))
        for g in evaluate_groups([scenarios[i] for i in plain_idx],
                                 device=device))
    slots: list[Optional[ScenarioResult]] = [None] * len(scenarios)
    if opt_idx:
        from ..core.tune import tune_scenario

        for i in opt_idx:
            tr = tune_scenario(scenarios[i], device=device)
            slots[i] = dataclasses.replace(
                tr.best_result, scenario=scenarios[i], conformance=None,
                breakdown=dict(tr.best_result.breakdown),
                iteration_breakdown=dict(tr.best_result.iteration_breakdown),
                meta={**dict(tr.best_result.meta), "tune": tr.to_dict()})
    conformance_cache: dict[str, dict] = {}
    for grp in groups:
        members = [scenarios[i] for i in grp.indices]
        out = grp.output
        n = len(members)

        def col(arr) -> np.ndarray:
            return np.broadcast_to(np.asarray(arr, np.float64), (n,))

        total_bits = col(out.total_bits())
        total_iters = col(out.total_iterations())
        offchip = col(out.offchip_bits())
        cache = col(out.cache_bits())
        onchip = col(out.onchip_bits())
        per_term_bits = {t.name: col(t.data_bits) for t in out.terms}
        per_term_iters = {t.name: col(t.iterations) for t in out.terms}
        n_tiles = out.meta.get("n_tiles")
        n_tiles_col = None if n_tiles is None else col(n_tiles)
        meta: dict = {}
        kind = members[0].graph_kind
        if kind == "trace":
            tr = out.meta["trace"]
            # Provenance: a sharded (factorization-only) build backs the
            # numbers as transparently as an edge list does.
            meta["trace"] = {"dataset": members[0].graph["dataset"],
                             "n_nodes": int(tr.n_nodes),
                             "n_edges": int(tr.n_edges),
                             "edge_list_free": not tr.has_edge_list}
        elif kind == "hetero":
            tr = out.meta["trace"]
            meta["trace"] = {
                "dataset": members[0].graph["dataset"],
                "n_nodes": int(tr.n_nodes),
                "n_edges": int(tr.n_edges),
                "n_relations": int(tr.n_relations),
                "relation_edge_counts": [
                    int(c) for c in tr.relation_edge_counts()],
            }
        elif kind == "minibatch":
            tr = _resolve_group_trace(members[0])
            sched = _group_schedule(members[0], tr)
            meta["minibatch"] = {
                "dataset": members[0].graph["dataset"],
                "n_nodes": int(tr.n_nodes),
                "n_episodes": int(sched.n_tiles),
                "batch_nodes": int(sched.capacity),
                "sampled_edges": int(sched.n_edges),
                "gathered_sources": int(sched.halo_total),
            }
        for j, i in enumerate(grp.indices):
            s = members[j]
            conf = None
            if s.conformance:
                if s.dataflow not in conformance_cache:
                    conformance_cache[s.dataflow] = _conformance_summary(
                        s.dataflow, conformance_points, device)
                conf = conformance_cache[s.dataflow]
            slots[i] = ScenarioResult(
                scenario=s,
                total_bits=float(total_bits[j]),
                total_iterations=float(total_iters[j]),
                offchip_bits=float(offchip[j]),
                cache_bits=float(cache[j]),
                onchip_bits=float(onchip[j]),
                breakdown={k: float(v[j]) for k, v in per_term_bits.items()},
                iteration_breakdown={k: float(v[j])
                                     for k, v in per_term_iters.items()},
                n_tiles=None if n_tiles_col is None else float(n_tiles_col[j]),
                conformance=conf,
                meta=meta,
            )
    return BatchResult(results=tuple(slots), groups=groups)


def evaluate_scenario(scenario: Scenario, **kw) -> ScenarioResult:
    """Evaluate one scenario (a batch of one)."""
    return evaluate_scenarios([scenario], **kw).results[0]
