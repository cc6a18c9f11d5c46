"""``python -m repro_torch.api`` — the scenario front door of the port.

Evaluates scenario batches and prints one CSV row per scenario:

* ``--scenario batch.json`` — a batch file (``{"scenarios": [...]}`` or a
  bare list); repeatable;
* ``--template fig3`` — a named template (:mod:`repro_torch.api.templates`:
  the paper's Figures 3-7, ``comparison``, ``cora_end_to_end``,
  ``cora_trace``, ``rgcn_cora``, ``tune_cora``); repeatable;
* ``--workload gcn-cora`` — a workload config's tile-language bridge
  (``ArchDef.to_scenarios``, :mod:`repro_torch.configs`); repeatable, and
  narrowed by ``--shape`` (repeatable) and ``--dataflows A,B``.

``--list`` names the dataflows, templates, trace datasets and workload
bridges.

``--tune batch.json`` runs the design-space tuner instead: every scenario
of the batch must carry an ``{"optimize": ...}`` block, and one tuned row
per scenario is printed (winning configuration, objective, SRAM working
set, search statistics); ``--json`` also writes each search record with its
Pareto frontier.  ``--serve`` routes the batch through the coalescing
serve engine (:mod:`repro_torch.api.serve`): each scenario becomes its own
request, submitted from ``--serve-clients`` threads and coalesced inside
``--serve-window``-second windows; the results and gates are the direct
path's, bit for bit.

Trace and hetero scenarios (and the tuner's probes) count their exact
schedules with kernel K4, and ``conformance=True`` scenarios run their
kernels' check (K1-K3), on ``--device`` (``cuda`` by default; ``cpu`` runs
the plain versions).  ``--json [PATH]`` also writes the results as JSON.

Exit status: 2 on a schema error (an unknown optimize axis, a negative
budget, an infeasible budget, a tune batch mixed with other sources, an
unknown workload or shape, ``--shape`` / ``--dataflows`` without
``--workload``) or a missing card, 1 on any ``expect`` golden-drift
mismatch or failed conformance check, else 0.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys
from typing import Optional, Sequence

from ..backend import resolve_device
from .planner import BatchResult, evaluate_scenarios
from .scenario import Scenario, load_scenarios
from .templates import template, template_names

__all__ = ["main", "build_scenarios"]


def _print_listing() -> None:
    from ..configs import all_archs
    from ..core import registry
    from ..core.trace import trace_dataset_names

    print("registered dataflows:")
    for name in registry.names():
        spec = registry.get(name)
        runnable = " [runnable analogue]" if spec.has_runnable else ""
        print(f"  {name:14} {len(spec.movements)} movement levels{runnable}")
    print("\nscenario templates (--template NAME) [scenario kinds]:")
    for name in template_names():
        batch = template(name)
        kinds = sorted({("tune" if s.optimize is not None else s.graph_kind)
                        for s in batch.scenarios})
        print(f"  {name:18} {len(batch.scenarios):3d} scenarios "
              f"[{', '.join(kinds)}]")
    print("\ntrace datasets ({'kind': 'trace', 'dataset': NAME, ...}):")
    for name in trace_dataset_names():
        print(f"  {name}")
    print("\nworkload bridges (--workload NAME [--shape SHAPE]):")
    for arch in all_archs():
        shapes = [s for s in arch.shapes if s not in arch.skips]
        print(f"  {arch.name:20} [{arch.family}] shapes: {', '.join(shapes)}")


def build_scenarios(args: argparse.Namespace) -> list[Scenario]:
    if (args.shape or args.dataflows) and not args.workload:
        raise ValueError("--shape/--dataflows only filter --workload "
                         "bridges; they would be silently ignored for "
                         "--scenario/--template sources")
    scenarios: list[Scenario] = []
    for path in args.scenario or ():
        scenarios.extend(load_scenarios(path))
    for name in args.template or ():
        scenarios.extend(template(name).scenarios)
    if args.workload:
        from ..configs import get_arch

        dataflows = (tuple(args.dataflows.split(",")) if args.dataflows
                     else None)
        shapes = tuple(args.shape) if args.shape else None
        for name in args.workload:
            scenarios.extend(get_arch(name).to_scenarios(
                shapes=shapes, dataflows=dataflows))
    return scenarios


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Evaluate declarative scenario batches (tile, full, "
                    "trace, hetero and minibatch graph kinds, and workload "
                    "bridges) in broadcast closed form.")
    ap.add_argument("--scenario", action="append", metavar="PATH",
                    help="scenario batch JSON file (repeatable)")
    ap.add_argument("--template", action="append", metavar="NAME",
                    help=f"named template: {', '.join(template_names())}")
    ap.add_argument("--tune", action="append", metavar="PATH",
                    help="tune batch JSON (repeatable): every scenario must "
                         "carry an {'optimize': ...} block; prints one "
                         "tuned row per scenario")
    ap.add_argument("--workload", action="append", metavar="ARCH",
                    help="workload config bridge (a repro_torch.configs "
                         "name; repeatable)")
    ap.add_argument("--shape", action="append", metavar="SHAPE",
                    help="restrict --workload to these shapes (repeatable)")
    ap.add_argument("--dataflows", default=None, metavar="A,B,C",
                    help="comma-separated dataflows for --workload "
                         "(default: all registered)")
    ap.add_argument("--list", action="store_true",
                    help="list dataflows, templates, trace datasets and "
                         "workload bridges")
    ap.add_argument("--serve", action="store_true",
                    help="evaluate through the coalescing serve engine "
                         "(one concurrent request per scenario)")
    ap.add_argument("--serve-window", type=float, default=0.002,
                    metavar="SECONDS",
                    help="micro-batching window for --serve (default 0.002)")
    ap.add_argument("--serve-clients", type=int, default=8, metavar="N",
                    help="concurrent submitter threads for --serve "
                         "(default 8)")
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
        if not (args.scenario or args.template or args.workload
                or args.tune):
            return 0
    try:
        resolve_device(args.device)
    except RuntimeError as exc:  # no card: never fall back to the CPU
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.tune:
        return _tune_main(args)

    serve_metrics = None
    try:
        scenarios = build_scenarios(args)
        if not scenarios:
            ap.print_usage(sys.stderr)
            raise ValueError("no scenarios given (use --scenario/--template/"
                             "--workload, or --list)")
        if args.serve:
            res, serve_metrics = _serve_batch(args, scenarios)
        else:
            res = evaluate_scenarios(scenarios, device=args.device)
    except (ValueError, TypeError, KeyError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    _print_csv(res.rows())
    if serve_metrics is not None:
        print(f"# {len(res.results)} scenarios served in "
              f"{serve_metrics['windows']} windows / "
              f"{serve_metrics['evaluations']} evaluations (coalesce rate "
              f"{serve_metrics['coalesce_rate']:.3f}) on {args.device}")
    else:
        print(f"# {len(res.results)} scenarios in {res.n_evaluations} "
              f"broadcast evaluations "
              f"({len(res.evaluations_per_dataflow())} dataflows) on "
              f"{args.device}")
    _print_frontiers(res)
    status = _gate(res)
    for r in res.results:
        if r.conformance is not None and not r.conformance.get("ok", True):
            status = 1
            print(f"# CONFORMANCE FAILURE {r.scenario.dataflow}: "
                  f"{r.conformance}", file=sys.stderr)
    _write_json(args, res, status, serve_metrics)
    return status


def _print_csv(rows: list[dict]) -> None:
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(rows[0]))
    writer.writeheader()
    writer.writerows(rows)
    print(buf.getvalue(), end="")


def _print_frontiers(res: BatchResult) -> None:
    """One comment line per Pareto point of every tuned result."""
    for r in res.results:
        tune = r.meta.get("tune")
        if tune is None:
            continue
        name = r.scenario.label or r.scenario.workload or r.scenario.dataflow
        print(f"# frontier of {name} ({len(tune['frontier'])} points, SRAM "
              "ascending):")
        for p in tune["frontier"]:
            res = p["residency"]
            print(f"#   {p['dataflow']} tile_vertices={p['tile_vertices']:g} "
                  f"residency={res if isinstance(res, str) else '+'.join(res)}"
                  f" halo_dedup={p['halo_dedup']:g}: sram_bits="
                  f"{p['sram_bits']!r} objective={p['objective']!r}")


def _gate(res: BatchResult) -> int:
    """1 (with one line each on stderr) if any ``expect`` pin drifted."""
    status = 0
    for scenario, fails in res.expect_failures():
        status = 1
        name = scenario.label or scenario.workload or scenario.dataflow
        for f in fails:
            print(f"# GOLDEN DRIFT {name}: {f}", file=sys.stderr)
    return status


def _write_json(args: argparse.Namespace, res: BatchResult, status: int,
                serve_metrics: Optional[dict] = None) -> None:
    if args.json is None:
        return
    payload = res.to_dict()
    payload["status"] = "ok" if status == 0 else "failed"
    if serve_metrics is not None:
        payload["serve"] = serve_metrics
    with open(args.json, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.json}")


def _serve_batch(args: argparse.Namespace, scenarios: list[Scenario]
                 ) -> tuple[BatchResult, dict]:
    """Evaluate the batch through the serve engine on ``args.device``.

    Each scenario becomes its own request, submitted concurrently from a
    client thread pool, so same-plan scenarios coalesce across requests as
    independent callers' would.  Results come back in input order as a
    groupless :class:`BatchResult`, so rows and gates run unchanged.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .serve import ServeEngine

    engine = ServeEngine(window_s=args.serve_window, device=args.device)
    with engine:
        with ThreadPoolExecutor(
                max_workers=max(1, args.serve_clients)) as pool:
            handles = [pool.submit(engine.submit, [s]) for s in scenarios]
            served = [h.result() for h in handles]
    results = tuple(sr.results[0] for sr in served)
    return BatchResult(results=results, groups=()), engine.metrics()


def _tune_main(args: argparse.Namespace) -> int:
    """The ``--tune`` mode: every scenario must be an optimize scenario."""
    if args.scenario or args.template or args.workload:
        print("error: --tune is its own mode; a tune batch cannot be "
              "combined with --scenario/--template/--workload sources",
              file=sys.stderr)
        return 2
    try:
        scenarios: list[Scenario] = []
        for path in args.tune:
            scenarios.extend(load_scenarios(path))
        if not scenarios:
            raise ValueError("no scenarios in the tune batch")
        for i, s in enumerate(scenarios):
            if s.optimize is None:
                raise ValueError(
                    f"tune scenario #{i} ({s.label or s.dataflow}) has no "
                    "'optimize' block; use --scenario for plain "
                    "evaluation")
        # An infeasible budget (InfeasibleBudgetError, a ValueError) is a
        # client error too.
        res = evaluate_scenarios(scenarios, device=args.device)
    except (ValueError, TypeError, KeyError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    rows = []
    for r in res.results:
        t = r.meta["tune"]
        best = t["best"]
        rows.append({
            "label": r.scenario.label, "workload": r.scenario.workload,
            "graph_kind": r.scenario.graph_kind,
            "best_dataflow": best["dataflow"],
            "best_tile_vertices": best["tile_vertices"],
            "best_n_tiles": best.get("n_tiles"),
            "residency": best["residency"],
            "halo_dedup": best["halo_dedup"],
            "objective": best["objective"],
            "sram_bits": best["sram_bits"],
            "total_bits": r.total_bits,
            "method": t["method"],
            "n_candidates": t["n_candidates"],
            "n_feasible": t["n_feasible"],
            "n_groups": t["n_groups"],
            "frontier_size": len(t["frontier"]),
        })
    _print_csv(rows)
    n_cands = sum(r.meta["tune"]["n_candidates"] for r in res.results)
    n_groups = sum(r.meta["tune"]["n_groups"] for r in res.results)
    print(f"# {len(res.results)} tunes over {n_cands} candidate "
          f"configurations in {n_groups} broadcast evaluations on "
          f"{args.device}")
    _print_frontiers(res)
    status = _gate(res)
    _write_json(args, res, status)
    return status
