"""``python -m repro_torch.api`` — the scenario front door of the port.

Evaluates scenario batch files (``--scenario batch.json``, repeatable;
``{"scenarios": [...]}`` or a bare list) and prints one CSV row per
scenario.  Trace scenarios count their exact schedules with kernel K4 on
``--device`` (``cuda`` by default; ``cpu`` runs its plain version).

Exit status: 2 on a schema error (including the reference's scenario
features not ported yet) or a missing card, 1 on any ``expect``
golden-drift mismatch, else 0.
"""

from __future__ import annotations

import argparse
import csv
import io
import sys
from typing import Optional, Sequence

from ..backend import resolve_device
from .planner import evaluate_scenarios
from .scenario import Scenario, load_scenarios

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Evaluate declarative scenario batches (tile, full and "
                    "trace graph kinds) in broadcast closed form.")
    ap.add_argument("--scenario", action="append", metavar="PATH",
                    required=True,
                    help="scenario batch JSON file (repeatable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where trace schedules are counted (default cuda)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:  # no card: never fall back to the CPU
        print(f"error: {exc}", file=sys.stderr)
        return 2

    try:
        scenarios: list[Scenario] = []
        for path in args.scenario:
            scenarios.extend(load_scenarios(path))
        res = evaluate_scenarios(scenarios, device=args.device)
    except (ValueError, TypeError, KeyError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    rows = res.rows()
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(rows[0]) if rows else [])
    writer.writeheader()
    writer.writerows(rows)
    print(buf.getvalue(), end="")
    print(f"# {len(res.results)} scenarios in {res.n_evaluations} broadcast "
          f"evaluations on {args.device}")

    status = 0
    for scenario, fails in res.expect_failures():
        status = 1
        name = scenario.label or scenario.workload or scenario.dataflow
        for f in fails:
            print(f"# GOLDEN DRIFT {name}: {f}", file=sys.stderr)
    return status
