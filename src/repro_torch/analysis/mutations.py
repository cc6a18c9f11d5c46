"""Mutation battery: prove the auditor has teeth.

Each mutant injects a realistic transcription error into a registered
``DataflowSpec`` (without touching the module source) and re-audits.  The
battery passes only if *every* generated mutant is caught by at least one
engine:

``drop-sigma``
    Evaluate the closed forms with ``sigma = 1.0`` — the classic "forgot
    the word-width factor" bug.  Caught by the unit checker (a
    bits-carrying pin disappears from the reduction is not observable
    symbolically, but the numeric value pins and golden totals move) and
    by the value fingerprint.

``swap-NT``
    Transpose the tile dimensions (``N <-> T``) at the call boundary —
    a row/column mix-up.  Caught by the value fingerprint whenever a form
    is N/T-asymmetric, and by golden drift.

``degenerate-minimum``
    Replace the capacity operator ``terms.minimum`` with "first argument
    wins" inside the form's module globals — i.e. delete the bandwidth
    cap.  Only generated for specs whose baseline trace actually calls
    ``minimum`` (the tiled-SpMM forms do not).  Caught by value pins /
    golden drift, and often by unit errors when the waived mixed-unit
    ``min`` disappears.

"Caught" is decided against the *baseline* audit of the same spec under
the same envelope: new un-waived unit errors, any changed per-movement
fingerprint (symbol set + Sec. IV value pins), or a golden-total
mismatch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core import registry
from ..core.dataflow import DataflowSpec
from ..core.notation import paper_default_graph
from .audit import SpecAudit, audit_spec
from .tracer import TraceContext, trace_form, traced_record

__all__ = ["Mutant", "MutationOutcome", "mutate_spec", "run_mutation_battery"]


@dataclass(frozen=True)
class Mutant:
    """One mutated spec plus the description of the injected fault."""

    name: str
    description: str
    spec: DataflowSpec


@dataclass(frozen=True)
class MutationOutcome:
    spec: str
    mutant: str
    caught: bool
    caught_by: tuple[str, ...]

    def as_dict(self) -> dict:
        return {"spec": self.spec, "mutant": self.mutant,
                "caught": self.caught, "caught_by": list(self.caught_by)}


def _wrap_movements(spec: DataflowSpec, wrap: Callable, suffix: str
                    ) -> DataflowSpec:
    movements = tuple(
        dataclasses.replace(m, form=wrap(m.form)) for m in spec.movements
    )
    return dataclasses.replace(spec, name=f"{spec.name}::{suffix}",
                               movements=movements)


def _drop_sigma(spec: DataflowSpec) -> Optional[DataflowSpec]:
    hw = spec.hw_factory()
    if not hasattr(hw, "sigma"):
        return None

    def wrap(form):
        def mutated(g, h):
            return form(g, dataclasses.replace(h, sigma=1.0))
        mutated.__name__ = f"{getattr(form, '__name__', 'form')}__drop_sigma"
        return mutated

    return _wrap_movements(spec, wrap, "drop-sigma")


def _swap_nt(spec: DataflowSpec) -> Optional[DataflowSpec]:
    def wrap(form):
        def mutated(g, h):
            return form(dataclasses.replace(g, N=g.T, T=g.N), h)
        mutated.__name__ = f"{getattr(form, '__name__', 'form')}__swap_nt"
        return mutated

    return _wrap_movements(spec, wrap, "swap-NT")


def _spec_calls_minimum(spec: DataflowSpec) -> bool:
    """Baseline symbolic trace: does any movement hit ``terms.minimum``?"""
    graph = paper_default_graph()
    hw = spec.hw_factory()
    for m in spec.movements:
        ctx = TraceContext(movement=m.name)
        try:
            tg = traced_record(graph, "graph", ctx)
            th = traced_record(hw, "hw", ctx)
            trace_form(m.form, tg, th, ctx, movement=m.name)
        except Exception:
            continue
        if ctx.minimum_calls:
            return True
    return False


def _degenerate_minimum(spec: DataflowSpec) -> Optional[DataflowSpec]:
    if not _spec_calls_minimum(spec):
        return None

    def first_arg_wins(*xs):
        return np.asarray(xs[0], dtype=np.float64)

    def wrap(form):
        def mutated(g, h):
            glb = getattr(form, "__globals__", None)
            if glb is None or "minimum" not in glb:
                return form(g, h)
            saved = glb["minimum"]
            glb["minimum"] = first_arg_wins
            try:
                return form(g, h)
            finally:
                glb["minimum"] = saved
        mutated.__name__ = f"{getattr(form, '__name__', 'form')}__degen_min"
        return mutated

    return _wrap_movements(spec, wrap, "degenerate-minimum")


_MUTATORS: tuple[tuple[str, str, Callable], ...] = (
    ("drop-sigma", "evaluate with sigma=1.0 (word width dropped)",
     _drop_sigma),
    ("swap-NT", "transpose tile dimensions N<->T at the call boundary",
     _swap_nt),
    ("degenerate-minimum", "capacity min(...) returns its first argument",
     _degenerate_minimum),
)


def mutate_spec(spec: DataflowSpec) -> list[Mutant]:
    """All applicable mutants of ``spec`` (non-applicable ones skipped)."""
    out = []
    for name, desc, fn in _MUTATORS:
        mutated = fn(spec)
        if mutated is not None:
            out.append(Mutant(name=name, description=desc, spec=mutated))
    return out


def _compare(baseline: SpecAudit, mutated: SpecAudit) -> tuple[str, ...]:
    """Engines that flag the mutant relative to its baseline audit."""
    caught_by = []
    base_unit = {m.movement: len(m.errors) for m in baseline.movements}
    for m in mutated.movements:
        if len(m.errors) > base_unit.get(m.movement, 0):
            caught_by.append("unit-checker")
            break
    base_fp = {m.movement: m.fingerprint for m in baseline.movements}
    for m in mutated.movements:
        if m.fingerprint != base_fp.get(m.movement):
            caught_by.append("provenance/value-pins")
            break
    if baseline.golden_ok and not mutated.golden_ok:
        caught_by.append("golden-totals")
    return tuple(caught_by)


def run_mutation_battery(specs=None, *, envelope=None
                         ) -> list[MutationOutcome]:
    """Audit every applicable mutant of every spec; report catch status.

    ``specs`` defaults to all registered dataflows.  A healthy auditor
    catches 100% of generated mutants (asserted in CI via ``--strict``).
    """
    if specs is None:
        specs = [registry.get(n) for n in registry.names()]
    outcomes: list[MutationOutcome] = []
    for spec in specs:
        baseline = audit_spec(spec, envelope=envelope)
        for mutant in mutate_spec(spec):
            # The mutant's golden lookup must resolve to the parent's pins:
            # audit against the parent name by restoring it post-replace.
            audited = audit_spec(
                dataclasses.replace(mutant.spec, name=spec.name),
                envelope=envelope, use_cache=False)
            caught_by = _compare(baseline, audited)
            outcomes.append(MutationOutcome(
                spec=spec.name, mutant=mutant.name,
                caught=bool(caught_by), caught_by=caught_by))
    return outcomes
