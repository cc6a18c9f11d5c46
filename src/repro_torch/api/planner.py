"""Batch planner: evaluate scenario batches with one broadcast call per plan
(a copy of the reference's ``repro/api/planner.py`` for the ``tile``,
``full`` and ``trace`` kinds).

``evaluate_scenarios`` groups scenarios by :meth:`Scenario.plan_key` and
evaluates each group in one closed-form call: every numeric leaf (graph
fields, hardware overrides, layer widths, tile capacities) is stacked along
a leading batch axis.  The closed forms are elementwise float64 algebra, so
the stacked evaluation is bit-identical to evaluating each scenario alone.
A trace group's exact schedules come from kernel K4 on ``device`` (CUDA
unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

from ..core import registry
from ..core.compose import FullGraphParams, MultiLayerModel, TiledGraphModel
from ..core.notation import GraphTileParams
from ..core.terms import ModelOutput
from ..core.trace import resolve_trace_dataset
from .scenario import Scenario, TILE_GRAPH_FIELDS

__all__ = [
    "EXPECT_REL_TOL",
    "ScenarioResult",
    "GroupResult",
    "BatchResult",
    "evaluate_scenarios",
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
            got = {"total_bits": self.total_bits,
                   "total_iterations": self.total_iterations}
            for key, want in self.scenario.expect.items():
                have = got.get(key)
                if have is None or not np.isclose(have, want,
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


def _group_model(spec, scenarios: Sequence[Scenario], trace=None,
                 device=None):
    """The (possibly composed) model shared by one plan group; ``trace``
    switches the tiled model onto the exact edge-list schedule, with tile
    capacities stacked along the capacity axis."""
    comp = scenarios[0].composition
    if comp is None:
        return spec
    inner = spec
    if comp.widths is not None:
        widths = tuple(
            _stack(s.composition.widths[i] for s in scenarios)
            for i in range(len(comp.widths)))
        inner = MultiLayerModel(spec, widths, residency=comp.residency)
    if comp.tile_vertices is None:
        return inner
    tile_vertices = _stack(s.composition.tile_vertices for s in scenarios)
    if trace is not None:
        return TiledGraphModel(inner, tile_vertices=tile_vertices,
                               trace=trace, device=device)
    return TiledGraphModel(inner, tile_vertices=tile_vertices,
                           halo_dedup=comp.halo_dedup)


def _group_graph(scenarios: Sequence[Scenario], trace=None):
    kind = scenarios[0].graph_kind
    if kind == "tile":
        return GraphTileParams(**{
            f: _stack(s.graph[f] for s in scenarios)
            for f in TILE_GRAPH_FIELDS})
    if kind == "trace":
        # V/E are properties of the resolved edge list, shared across the
        # group (the dataset reference is part of the plan key).
        V, E = float(trace.n_nodes), float(trace.n_edges)
    else:
        V = _stack(s.graph["V"] for s in scenarios)
        E = _stack(s.graph["E"] for s in scenarios)
    return FullGraphParams(
        V=V, E=E,
        N=_stack(s.graph["N"] for s in scenarios),
        T=_stack(s.graph["T"] for s in scenarios),
        high_degree_fraction=_stack(s.graph["high_degree_fraction"]
                                    for s in scenarios),
    )


def _evaluate_group(scenarios: Sequence[Scenario], device) -> ModelOutput:
    first = scenarios[0]
    spec = registry.get(first.dataflow)
    trace = None
    if first.graph_kind == "trace":
        trace = resolve_trace_dataset(first.graph["dataset"],
                                      first.graph["params"])
    model = _group_model(spec, scenarios, trace=trace, device=device)
    graph = _group_graph(scenarios, trace=trace)
    hw = _group_hw(spec, scenarios)
    # THE one broadcast closed-form call for this group.
    return model.evaluate(graph, hw)


def evaluate_scenarios(scenarios: Sequence[Scenario], *,
                       device=None) -> BatchResult:
    """Evaluate a scenario batch: one broadcast call per plan group.

    Results come back in input order.  Trace groups count their schedules
    with kernel K4 on ``device``: CUDA unless ``device="cpu"``, and without
    a card the call raises rather than run on the CPU.
    """
    scenarios = list(scenarios)
    for i, s in enumerate(scenarios):
        if not isinstance(s, Scenario):
            raise TypeError(f"scenarios[{i}] is {type(s).__name__}, "
                            "expected Scenario")
    by_key: dict[tuple, list[int]] = {}
    for i, s in enumerate(scenarios):
        by_key.setdefault(s.plan_key(), []).append(i)
    groups = tuple(
        GroupResult(dataflow=scenarios[idx[0]].dataflow, plan_key=key,
                    indices=tuple(idx),
                    output=_evaluate_group([scenarios[i] for i in idx],
                                           device))
        for key, idx in by_key.items())
    slots: list[Optional[ScenarioResult]] = [None] * len(scenarios)
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
        if members[0].graph_kind == "trace":
            tr = out.meta["trace"]
            meta["trace"] = {"dataset": members[0].graph["dataset"],
                             "n_nodes": int(tr.n_nodes),
                             "n_edges": int(tr.n_edges)}
        for j, i in enumerate(grp.indices):
            slots[i] = ScenarioResult(
                scenario=members[j],
                total_bits=float(total_bits[j]),
                total_iterations=float(total_iters[j]),
                offchip_bits=float(offchip[j]),
                cache_bits=float(cache[j]),
                onchip_bits=float(onchip[j]),
                breakdown={k: float(v[j]) for k, v in per_term_bits.items()},
                iteration_breakdown={k: float(v[j])
                                     for k, v in per_term_iters.items()},
                n_tiles=None if n_tiles_col is None else float(n_tiles_col[j]),
                meta=meta,
            )
    return BatchResult(results=tuple(slots), groups=groups)
