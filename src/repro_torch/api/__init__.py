"""``repro_torch.api`` — the port's scenario front door.

* :class:`~repro_torch.api.scenario.Scenario` /
  :class:`~repro_torch.api.scenario.Composition`: pure-data,
  JSON-round-trippable descriptions of one evaluation (``tile``, ``full``,
  ``trace``, ``hetero`` and ``minibatch`` graph kinds, optionally with
  ``conformance=True``);
* :func:`~repro_torch.api.planner.evaluate_scenarios`: one broadcast
  closed-form call per plan group, trace and typed-trace schedules counted
  by kernel K4, conformance checks run with kernels K1-K3;
* :mod:`~repro_torch.api.templates`: the paper's figures as named scenario
  batches, which the ``figN_*`` functions of :mod:`repro_torch.core.sweep`
  evaluate, and ``tune_cora``;
* :class:`~repro_torch.api.serve.ServeEngine`: concurrent scenario-batch
  requests coalesced across callers inside a micro-batching window,
  bit-identical to serial evaluation, with per-request coalesce and cache
  metrics under ``meta["serve"]``;
* the design-space tuner (:mod:`repro_torch.core.tune`, re-exported):
  scenarios with an ``{"optimize": ...}`` block;
* ``python -m repro_torch.api --scenario PATH | --template NAME |
  --workload ARCH [--shape SHAPE] [--dataflows A,B] | --tune PATH
  [--serve] [--device cuda|cpu] [--json [PATH]] [--list]``; workload
  configs join through :meth:`repro_torch.configs.base.ArchDef.
  to_scenarios`, the paper's tile language for each architecture.
"""

from ..core.tune import (InfeasibleBudgetError, TunePoint, TuneResult,
                         tune_scenario)
from .planner import (BatchResult, GroupResult, ScenarioResult,
                      coalesce_scenarios, evaluate_groups, evaluate_scenario,
                      evaluate_scenarios)
from .scenario import (Composition, FULL_GRAPH_FIELDS, HETERO_GRAPH_FIELDS,
                       MINIBATCH_GRAPH_FIELDS, Scenario, TILE_GRAPH_FIELDS,
                       TRACE_GRAPH_FIELDS, dump_scenarios, load_scenarios,
                       scenarios_to_dicts)
from .serve import ServeEngine, ServeError, ServeResult
from .templates import (TEMPLATES, TemplateBatch, template, template_names,
                        tile_scenarios_from_graph, trace_scenarios_from_graph)

__all__ = [
    "Scenario",
    "Composition",
    "TILE_GRAPH_FIELDS",
    "FULL_GRAPH_FIELDS",
    "TRACE_GRAPH_FIELDS",
    "HETERO_GRAPH_FIELDS",
    "MINIBATCH_GRAPH_FIELDS",
    "load_scenarios",
    "dump_scenarios",
    "scenarios_to_dicts",
    "ScenarioResult",
    "GroupResult",
    "BatchResult",
    "evaluate_scenario",
    "evaluate_scenarios",
    "evaluate_groups",
    "coalesce_scenarios",
    "ServeEngine",
    "ServeResult",
    "ServeError",
    "TemplateBatch",
    "TEMPLATES",
    "template",
    "template_names",
    "tile_scenarios_from_graph",
    "trace_scenarios_from_graph",
    "InfeasibleBudgetError",
    "TunePoint",
    "TuneResult",
    "tune_scenario",
]
