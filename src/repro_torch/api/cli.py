"""``python -m repro_torch.api`` — the scenario front door of the port.

Evaluates scenario batches and prints one CSV row per scenario:

* ``--scenario batch.json`` — a batch file (``{"scenarios": [...]}`` or a
  bare list); repeatable;
* ``--template fig3`` — a named template (:mod:`repro_torch.api.templates`:
  the paper's Figures 3-7, ``comparison``, ``cora_end_to_end``,
  ``cora_trace``, ``rgcn_cora``); repeatable.  ``--list`` names them all.

Trace and hetero scenarios count their exact schedules with kernel K4, and
``conformance=True`` scenarios run their kernels' check (K1-K3), on
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions).
``--json [PATH]`` also writes the results as JSON.

Exit status: 2 on a schema error (including the reference's scenario
features not ported yet) or a missing card, 1 on any ``expect``
golden-drift mismatch or failed conformance check, else 0.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys
from typing import Optional, Sequence

from ..backend import resolve_device
from .planner import evaluate_scenarios
from .scenario import Scenario, load_scenarios
from .templates import template, template_names

__all__ = ["main", "build_scenarios"]


def _print_listing() -> None:
    from ..core import registry
    from ..core.trace import trace_dataset_names

    print("registered dataflows:")
    for name in registry.names():
        spec = registry.get(name)
        runnable = " [runnable analogue]" if spec.has_runnable else ""
        print(f"  {name:14} {len(spec.movements)} movement levels{runnable}")
    print("\nscenario templates (--template NAME) [scenario kinds]:")
    for name in template_names():
        try:
            batch = template(name)
        except ValueError as exc:
            print(f"  {name:18} {exc}")
            continue
        kinds = sorted({s.graph_kind for s in batch.scenarios})
        print(f"  {name:18} {len(batch.scenarios):3d} scenarios "
              f"[{', '.join(kinds)}]")
    print("\ntrace datasets ({'kind': 'trace', 'dataset': NAME, ...}):")
    for name in trace_dataset_names():
        print(f"  {name}")


def build_scenarios(args: argparse.Namespace) -> list[Scenario]:
    if args.dataflows:
        raise ValueError("--dataflows only filters --workload bridges, which "
                         "are not ported to repro_torch yet; see ROADMAP.md "
                         "Queue 1 item 4f")
    scenarios: list[Scenario] = []
    for path in args.scenario or ():
        scenarios.extend(load_scenarios(path))
    for name in args.template or ():
        scenarios.extend(template(name).scenarios)
    return scenarios


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Evaluate declarative scenario batches (tile, full, "
                    "trace, hetero and minibatch graph kinds) in broadcast "
                    "closed form.")
    ap.add_argument("--scenario", action="append", metavar="PATH",
                    help="scenario batch JSON file (repeatable)")
    ap.add_argument("--template", action="append", metavar="NAME",
                    help=f"named template: {', '.join(template_names())}")
    ap.add_argument("--dataflows", default=None, metavar="A,B,C",
                    help="comma-separated dataflows for --workload bridges "
                         "(not ported yet)")
    ap.add_argument("--list", action="store_true",
                    help="list dataflows, templates and trace datasets")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where trace schedules are counted and "
                         "conformance checks run (default cuda)")
    ap.add_argument("--json", nargs="?", const="BENCH_torch_scenarios.json",
                    default=None, metavar="PATH",
                    help="write results JSON (default "
                         "BENCH_torch_scenarios.json)")
    args = ap.parse_args(argv)

    if args.list:
        _print_listing()
        if not (args.scenario or args.template):
            return 0
    try:
        resolve_device(args.device)
    except RuntimeError as exc:  # no card: never fall back to the CPU
        print(f"error: {exc}", file=sys.stderr)
        return 2

    try:
        scenarios = build_scenarios(args)
        if not scenarios:
            ap.print_usage(sys.stderr)
            raise ValueError("no scenarios given (use --scenario/--template, "
                             "or --list)")
        res = evaluate_scenarios(scenarios, device=args.device)
    except (ValueError, TypeError, KeyError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    rows = res.rows()
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(rows[0]))
    writer.writeheader()
    writer.writerows(rows)
    print(buf.getvalue(), end="")
    print(f"# {len(res.results)} scenarios in {res.n_evaluations} broadcast "
          f"evaluations ({len(res.evaluations_per_dataflow())} dataflows) on "
          f"{args.device}")

    status = 0
    for scenario, fails in res.expect_failures():
        status = 1
        name = scenario.label or scenario.workload or scenario.dataflow
        for f in fails:
            print(f"# GOLDEN DRIFT {name}: {f}", file=sys.stderr)
    for r in res.results:
        if r.conformance is not None and not r.conformance.get("ok", True):
            status = 1
            print(f"# CONFORMANCE FAILURE {r.scenario.dataflow}: "
                  f"{r.conformance}", file=sys.stderr)

    if args.json is not None:
        payload = res.to_dict()
        payload["status"] = "ok" if status == 0 else "failed"
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.json}")
    return status
