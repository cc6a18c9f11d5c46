"""``python -m repro_torch.analysis`` — the model-audit CLI.

Default run: audit every registered dataflow, lint the closed-form and
trace-path packages, and run the mutation battery; print a summary.

Flags::

    --strict            exit 1 on any strict audit error, lint violation,
                        or escaped mutant (the CI model-lint gate)
    --json PATH         write the machine-readable report
    --provenance        print the symbol-provenance markdown table
    --check             with --provenance: compare against the committed
                        DESIGN.md §16 appendix; exit 1 if stale
    --write             with --provenance: rewrite the DESIGN.md appendix
                        in place (between the BEGIN/END markers)
    --design PATH       DESIGN.md location (default: repo root)
    --no-mutations      skip the mutation battery (fast pre-commit loop)
    --max-edges F       override the P (edges) envelope upper bound
    --max-vertices F    override the K/L (vertices) envelope upper bound
    --max-features F    override the N/T (elements) envelope upper bound

Exit codes: 0 clean, 1 audit/lint/mutation/drift failure, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .audit import (audit_composition_forms, audit_registry,
                    render_provenance)
from .lint import lint_paths
from .mutations import run_mutation_battery

PROVENANCE_BEGIN = "<!-- BEGIN ANALYSIS PROVENANCE -->"
PROVENANCE_END = "<!-- END ANALYSIS PROVENANCE -->"


def _default_design_path() -> Path:
    return Path(__file__).resolve().parents[3] / "DESIGN.md"


def _build_envelope(args) -> dict:
    envelope: dict[str, tuple[float, float]] = {}
    if args.max_edges is not None:
        envelope["P"] = (0.0, float(args.max_edges))
    if args.max_vertices is not None:
        envelope["K"] = (1.0, float(args.max_vertices))
        envelope["L"] = (0.0, float(args.max_vertices))
    if args.max_features is not None:
        envelope["N"] = (1.0, float(args.max_features))
        envelope["T"] = (1.0, float(args.max_features))
    return envelope


def extract_committed_provenance(design_text: str) -> str | None:
    """The committed appendix between the BEGIN/END markers, or None."""
    try:
        _, rest = design_text.split(PROVENANCE_BEGIN, 1)
        body, _ = rest.split(PROVENANCE_END, 1)
    except ValueError:
        return None
    return body.strip("\n") + "\n"


def replace_committed_provenance(design_text: str, table: str) -> str:
    """Design text with the appendix body replaced (markers must exist)."""
    head, rest = design_text.split(PROVENANCE_BEGIN, 1)
    _, tail = rest.split(PROVENANCE_END, 1)
    return (head + PROVENANCE_BEGIN + "\n" + table.strip("\n") + "\n"
            + PROVENANCE_END + tail)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Symbolic units/provenance/overflow audit + AST lint "
                    "over every registered dataflow model.")
    parser.add_argument("--strict", action="store_true")
    parser.add_argument("--json", metavar="PATH", default=None)
    parser.add_argument("--provenance", action="store_true")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--write", action="store_true")
    parser.add_argument("--design", metavar="PATH", default=None)
    parser.add_argument("--no-mutations", action="store_true")
    parser.add_argument("--max-edges", type=float, default=None)
    parser.add_argument("--max-vertices", type=float, default=None)
    parser.add_argument("--max-features", type=float, default=None)
    args = parser.parse_args(argv)

    if (args.check or args.write) and not args.provenance:
        print("error: --check/--write require --provenance", file=sys.stderr)
        return 2
    if args.check and args.write:
        print("error: --check and --write are mutually exclusive",
              file=sys.stderr)
        return 2

    envelope = _build_envelope(args)
    audits = audit_registry(envelope=envelope or None)
    # The composition-layer closed forms (DESIGN.md §17) audit as a
    # pseudo-dataflow so strict gating and provenance cover them too.
    audits["composition"] = audit_composition_forms(envelope=envelope or None)
    table = render_provenance(audits)

    # --provenance: table-centric modes short-circuit the full report.
    if args.provenance:
        design_path = Path(args.design) if args.design \
            else _default_design_path()
        if args.check:
            committed = extract_committed_provenance(
                design_path.read_text()) if design_path.exists() else None
            if committed is None:
                print(f"provenance: no committed appendix found in "
                      f"{design_path} (markers missing)", file=sys.stderr)
                return 1
            if committed != table:
                print("provenance: committed DESIGN.md appendix is STALE — "
                      "regenerate with `python -m repro_torch.analysis "
                      "--provenance --write`", file=sys.stderr)
                return 1
            print(f"provenance: DESIGN.md appendix is current "
                  f"({sum(len(a.movements) for a in audits.values())} "
                  f"movements)")
            return 0
        if args.write:
            text = design_path.read_text()
            if PROVENANCE_BEGIN not in text or PROVENANCE_END not in text:
                print(f"provenance: {design_path} lacks the "
                      f"{PROVENANCE_BEGIN} / {PROVENANCE_END} markers",
                      file=sys.stderr)
                return 1
            design_path.write_text(replace_committed_provenance(text, table))
            print(f"provenance: rewrote appendix in {design_path}")
            return 0
        print(table, end="")
        return 0

    violations = lint_paths()
    outcomes = [] if args.no_mutations else run_mutation_battery(
        envelope=envelope or None)

    strict_errors: list[str] = []
    for name in sorted(audits):
        strict_errors.extend(audits[name].strict_errors())
    escaped = [o for o in outcomes if not o.caught]

    report = {
        "schema": "repro_torch.analysis/v1",
        "strict": bool(args.strict),
        "envelope": {k: list(v) for k, v in envelope.items()},
        "dataflows": {name: audits[name].as_dict()
                      for name in sorted(audits)},
        "lint": {
            "roots": ["src/repro_torch/core", "src/repro_torch/distributed"],
            "violations": [v.as_dict() for v in violations],
        },
        "mutation_battery": {
            "ran": not args.no_mutations,
            "total": len(outcomes),
            "caught": sum(o.caught for o in outcomes),
            "outcomes": [o.as_dict() for o in outcomes],
        },
        "ok": not (strict_errors or violations or escaped),
    }
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2,
                                              sort_keys=True) + "\n")

    for name in sorted(audits):
        a = audits[name]
        status = "ok" if a.ok else "FAIL"
        print(f"{name:14s} {status:4s} movements={len(a.movements)} "
              f"unit_errors={a.unit_error_count} "
              f"waived={a.waived_issue_count} "
              f"overflow_findings={a.overflow_count} "
              f"dead_hw={','.join(a.dead_hw) or '-'}")
    for err in strict_errors:
        print(f"  strict: {err}", file=sys.stderr)
    if violations:
        print(f"lint: {len(violations)} violation(s)")
        for v in violations:
            print(f"  {v}", file=sys.stderr)
    else:
        print("lint: clean")
    if outcomes:
        print(f"mutation battery: {sum(o.caught for o in outcomes)}"
              f"/{len(outcomes)} mutants caught")
        for o in escaped:
            print(f"  ESCAPED: {o.spec} :: {o.mutant}", file=sys.stderr)

    failed = bool(strict_errors or violations or escaped)
    if args.strict and failed:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
