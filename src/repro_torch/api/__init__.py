"""``repro_torch.api`` — the port's scenario front door.

* :class:`~repro_torch.api.scenario.Scenario` /
  :class:`~repro_torch.api.scenario.Composition`: pure-data,
  JSON-round-trippable descriptions of one evaluation (``tile``, ``full``
  and ``trace`` graph kinds);
* :func:`~repro_torch.api.planner.evaluate_scenarios`: one broadcast
  closed-form call per plan group, trace schedules counted by kernel K4;
* ``python -m repro_torch.api --scenario PATH [--device cuda|cpu]``.
"""

from .planner import (BatchResult, GroupResult, ScenarioResult,
                      evaluate_scenarios)
from .scenario import Composition, Scenario, load_scenarios

__all__ = ["Scenario", "Composition", "load_scenarios", "ScenarioResult",
           "GroupResult", "BatchResult", "evaluate_scenarios"]
