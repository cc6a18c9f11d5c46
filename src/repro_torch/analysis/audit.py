"""The model auditor: one symbolic-trace pass per registered movement.

``audit_spec`` runs every ``MovementSpec.form`` of a dataflow under the
:mod:`repro_torch.analysis.tracer` and derives three results per movement:

* **dimensional consistency** — the returned ``data_bits`` must reduce to
  ``bits^1`` and ``iterations`` to ``bits^0`` under the Table II unit
  declarations (:mod:`repro_torch.core.notation`), with every intermediate
  ``min``/``+``/``where`` unit-matched and every ``ceil`` applied to a
  dimensionless ratio.  Violations are hard errors unless the movement
  carries an ``audit_note`` waiver (a verbatim-transcription decision
  recorded in the spec module and DESIGN.md §16).
* **symbol provenance** — the set of graph/hardware fields that reach the
  movement's outputs.  Aggregated across movements this yields the
  spec-level provenance table and the dead-hardware-parameter check: a
  declared hw field no movement reads is a strict error unless listed in
  ``DataflowSpec.unused_hw``.
* **float64-exactness** — interval bounds propagated from the declared
  operating envelope (10^9 edges / 10^7 vertices by default); any
  intermediate whose bound exceeds 2^53 is reported with its witness
  symbols.  These are findings, not strict failures — the envelope
  deliberately overshoots today's workloads.

A fourth, dynamic layer pins each movement's ``(data_bits, iterations)``
at the Sec. IV default operating point and the spec total against
``SEC4_GOLDEN_TOTALS`` where one exists; together with provenance this is
the fingerprint the mutation battery (:mod:`repro_torch.analysis.mutations`)
uses to prove the auditor rejects wrong models.

Audits are cached by spec *value* (DataflowSpec is a frozen dataclass, so
a re-registered mutated spec — new form callables — never hits a stale
entry; see ``analysis_cache_info``/``clear_analysis_cache``).
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np

from ..core.dataflow import DataflowSpec
from ..core.notation import paper_default_graph
from .tracer import (FLOAT64_EXACT_MAX, OverflowRecord, TraceAbort,
                     TraceContext, UnitIssue, traced_record, trace_form)

__all__ = [
    "MovementAudit",
    "SpecAudit",
    "audit_spec",
    "audit_registry",
    "audit_composition_forms",
    "analysis_cache_info",
    "clear_analysis_cache",
    "render_provenance",
    "DEFAULT_ENVELOPE",
    "COMPOSITION_AUDIT_POINT",
]

#: Envelope overrides the overflow audit defaults to: none, so the per-field
#: declarations in :mod:`repro_torch.core.notation` hold; overriding them is
#: only needed to *tighten or widen* the audited scale (CLI --max-edges /
#: --max-vertices / --max-features).
DEFAULT_ENVELOPE: dict[str, tuple[float, float]] = {}


@dataclass(frozen=True)
class MovementAudit:
    """Everything one tracer pass proved about a single movement level."""

    movement: str
    role: str
    hierarchy: str
    bits_unit: str
    iters_unit: str
    symbols: tuple[str, ...]
    unit_issues: tuple[UnitIssue, ...]
    waived: bool
    audit_note: Optional[str]
    overflows: tuple[OverflowRecord, ...]
    minimum_calls: int
    trace_error: Optional[str]
    bits_bound: float
    iters_bound: float
    value_bits: float
    value_iters: float

    @property
    def graph_symbols(self) -> tuple[str, ...]:
        return tuple(s.split(".", 1)[1] for s in self.symbols
                     if s.startswith("graph."))

    @property
    def hw_symbols(self) -> tuple[str, ...]:
        return tuple(s.split(".", 1)[1] for s in self.symbols
                     if s.startswith("hw."))

    @property
    def errors(self) -> tuple[str, ...]:
        """Strict failures: unwaived unit issues and untraceable forms."""
        errs = []
        if self.trace_error:
            errs.append(self.trace_error)
        if not self.waived:
            errs.extend(str(i) for i in self.unit_issues)
        return tuple(errs)

    @property
    def fingerprint(self) -> tuple:
        """What the mutation battery compares: provenance + value pins."""
        return (self.movement, self.symbols, self.bits_unit,
                self.iters_unit, self.value_bits, self.value_iters)

    def as_dict(self) -> dict:
        return {
            "movement": self.movement,
            "role": self.role,
            "hierarchy": self.hierarchy,
            "bits_unit": self.bits_unit,
            "iters_unit": self.iters_unit,
            "graph_symbols": list(self.graph_symbols),
            "hw_symbols": list(self.hw_symbols),
            "unit_issues": [str(i) for i in self.unit_issues],
            "waived": self.waived,
            "audit_note": self.audit_note,
            "overflow_bound": max((o.bound for o in self.overflows),
                                  default=0.0),
            "overflow_ops": len(self.overflows),
            "trace_error": self.trace_error,
            "bits_bound": self.bits_bound,
            "value_bits": self.value_bits,
            "value_iterations": self.value_iters,
        }


@dataclass(frozen=True)
class SpecAudit:
    """The full audit of one dataflow spec."""

    name: str
    movements: tuple[MovementAudit, ...]
    dead_hw: tuple[str, ...]
    waived_dead_hw: tuple[str, ...]
    unused_graph: tuple[str, ...]
    golden_expected: Optional[float]
    golden_actual: Optional[float]
    envelope: tuple[tuple[str, tuple[float, float]], ...]

    @property
    def golden_ok(self) -> bool:
        if self.golden_expected is None:
            return True
        return self.golden_actual == self.golden_expected

    @property
    def unit_error_count(self) -> int:
        return sum(len(m.unit_issues) for m in self.movements
                   if not m.waived)

    @property
    def waived_issue_count(self) -> int:
        return sum(len(m.unit_issues) for m in self.movements if m.waived)

    @property
    def overflow_count(self) -> int:
        return sum(len(m.overflows) for m in self.movements)

    @property
    def symbols(self) -> frozenset:
        out = frozenset()
        for m in self.movements:
            out = out | frozenset(m.symbols)
        return out

    def strict_errors(self) -> tuple[str, ...]:
        """Everything ``--strict`` fails on (overflows are findings only)."""
        errs: list[str] = []
        for m in self.movements:
            errs.extend(f"{self.name}.{e}" if not e.startswith(self.name)
                        else e for e in m.errors)
        for p in self.dead_hw:
            errs.append(f"{self.name}: hardware parameter hw.{p} is never "
                        f"read by any movement (declare it in "
                        f"DataflowSpec.unused_hw with a justification, or "
                        f"fix the form that should read it)")
        if not self.golden_ok:
            errs.append(f"{self.name}: Sec. IV total {self.golden_actual!r} "
                        f"drifted from the pinned golden "
                        f"{self.golden_expected!r}")
        return tuple(errs)

    @property
    def ok(self) -> bool:
        return not self.strict_errors()

    @property
    def fingerprint(self) -> tuple:
        return tuple(m.fingerprint for m in self.movements)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "unit_errors": self.unit_error_count,
            "waived_unit_issues": self.waived_issue_count,
            "overflow_findings": self.overflow_count,
            "dead_hw": list(self.dead_hw),
            "waived_dead_hw": list(self.waived_dead_hw),
            "unused_graph": list(self.unused_graph),
            "golden_ok": self.golden_ok,
            "strict_errors": list(self.strict_errors()),
            "movements": [m.as_dict() for m in self.movements],
        }


# -- caching ----------------------------------------------------------------
_AUDIT_CACHE: "weakref.WeakKeyDictionary[DataflowSpec, dict]" = \
    weakref.WeakKeyDictionary()
_CACHE_STATS = {"hits": 0, "misses": 0}


def analysis_cache_info() -> dict:
    return {"entries": len(_AUDIT_CACHE), **_CACHE_STATS}


def clear_analysis_cache() -> None:
    _AUDIT_CACHE.clear()
    _COMPOSITION_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


def _envelope_key(envelope: Optional[Mapping]) -> tuple:
    if not envelope:
        return ()
    return tuple(sorted((k, (float(lo), float(hi)))
                        for k, (lo, hi) in envelope.items()))


def _declared_movement_waiver(movement) -> Optional[str]:
    return getattr(movement, "audit_note", None)


def _spec_unused_hw(spec: DataflowSpec) -> tuple[str, ...]:
    return tuple(getattr(spec, "unused_hw", ()) or ())


def audit_spec(spec: DataflowSpec, *,
               envelope: Optional[Mapping[str, tuple]] = None,
               use_cache: bool = True) -> SpecAudit:
    """Audit one dataflow spec; results are cached by spec value.

    ``envelope`` overrides the declared graph-field bounds, e.g.
    ``{"P": (0, 1e10)}`` to audit a 10^10-edge push before attempting it.
    """
    key = _envelope_key(envelope)
    if use_cache:
        per_spec = _AUDIT_CACHE.get(spec)
        if per_spec is not None and key in per_spec:
            _CACHE_STATS["hits"] += 1
            return per_spec[key]
        _CACHE_STATS["misses"] += 1

    base_graph = paper_default_graph()
    base_hw = spec.hw_factory()

    # Dynamic value pins at the Sec. IV default operating point.
    values: dict[str, tuple[float, float]] = {}
    golden_actual = None
    try:
        out = spec.evaluate(base_graph)
        for t in out.terms:
            values[t.name] = (float(np.asarray(t.data_bits)),
                              float(np.asarray(t.iterations)))
        golden_actual = float(out.total_bits())
    except Exception as e:  # a spec too broken to evaluate still audits
        values = {}
        golden_actual = float("nan")
        eval_error = f"{spec.name}: evaluation at Sec. IV defaults raised " \
                     f"{type(e).__name__}: {e}"
    else:
        eval_error = None

    from ..core.validation import SEC4_GOLDEN_TOTALS
    golden_expected = (SEC4_GOLDEN_TOTALS[spec.name][0]
                       if spec.name in SEC4_GOLDEN_TOTALS else None)
    if golden_expected is None:
        golden_actual = None

    audits = []
    used_symbols: set[str] = set()
    traced_hw_fields: set[str] = set()
    for m in spec.movements:
        ctx = TraceContext(movement=f"{spec.name}.{m.name}")
        tg = traced_record(base_graph, "graph", ctx, overrides=envelope)
        th = traced_record(base_hw, "hw", ctx)
        traced_hw_fields.update(
            f.name for f in dataclasses.fields(base_hw)
            if getattr(base_hw, f.name) is not None)
        trace_error = None
        bits_unit = iters_unit = "untraced"
        symbols: tuple[str, ...] = ()
        bits_bound = iters_bound = float("nan")
        try:
            bits, iters = trace_form(m.form, tg, th, ctx,
                                     movement=f"{spec.name}.{m.name}")
        except TraceAbort as e:
            trace_error = str(e)
        except Exception as e:
            trace_error = (f"{spec.name}.{m.name}: tracer raised "
                           f"{type(e).__name__}: {e}")
        else:
            bits_unit, iters_unit = str(bits.unit), str(iters.unit)
            if not bits.unit.is_bits:
                ctx.issue("data_bits", f"reduces to {bits.unit}, expected "
                                       f"bits (a count x count product is "
                                       f"not data movement)")
            if not iters.unit.is_dimensionless:
                ctx.issue("iterations", f"reduces to {iters.unit}, "
                                        f"expected dimensionless")
            symbols = tuple(sorted(bits.symbols | iters.symbols))
            bits_bound, iters_bound = bits.hi, iters.hi
        note = _declared_movement_waiver(m)
        vb, vi = values.get(m.name, (float("nan"), float("nan")))
        audits.append(MovementAudit(
            movement=m.name, role=m.role, hierarchy=m.hierarchy,
            bits_unit=bits_unit, iters_unit=iters_unit, symbols=symbols,
            unit_issues=tuple(ctx.issues), waived=note is not None,
            audit_note=note, overflows=tuple(ctx.overflows),
            minimum_calls=ctx.minimum_calls,
            trace_error=trace_error if trace_error else eval_error,
            bits_bound=bits_bound, iters_bound=iters_bound,
            value_bits=vb, value_iters=vi))
        used_symbols.update(symbols)
        # Only the first movement needs to report the spec-wide eval error.
        eval_error = None

    used_hw = {s.split(".", 1)[1] for s in used_symbols
               if s.startswith("hw.")}
    used_graph = {s.split(".", 1)[1] for s in used_symbols
                  if s.startswith("graph.")}
    waivers = _spec_unused_hw(spec)
    dead = sorted(traced_hw_fields - used_hw)
    dead_hw = tuple(p for p in dead if p not in waivers)
    waived_dead = tuple(p for p in dead if p in waivers)
    graph_fields = {f.name for f in dataclasses.fields(base_graph)}
    unused_graph = tuple(sorted(graph_fields - used_graph))

    report = SpecAudit(
        name=spec.name, movements=tuple(audits), dead_hw=dead_hw,
        waived_dead_hw=waived_dead, unused_graph=unused_graph,
        golden_expected=golden_expected, golden_actual=golden_actual,
        envelope=key)
    if use_cache:
        _AUDIT_CACHE.setdefault(spec, {})[key] = report
    return report


def audit_registry(*, envelope: Optional[Mapping[str, tuple]] = None,
                   use_cache: bool = True) -> dict[str, SpecAudit]:
    """Audit every registered dataflow; keyed by registry name."""
    from ..core import registry

    return {name: audit_spec(registry.get(name), envelope=envelope,
                             use_cache=use_cache)
            for name in registry.names()}


# -- composition-layer forms (DESIGN.md §17) --------------------------------

#: (role, hierarchy) of each composition-layer term, matching what the
#: array-path evaluations in :mod:`repro_torch.core.compose` charge.
_COMPOSITION_TERM_INFO = {
    "relationalhalo": ("vertex_in", "L2-L1"),
    "relationalhandoff": ("interphase", "L1-L1"),
    "minibatchgather": ("vertex_in", "L2-L1"),
}

#: The §17 operating point the composition value pins are taken at: a
#: 4-relation typed graph, 256-vertex tiles with 100 unique remote
#: sources, 32 halo feature elements per vertex.
COMPOSITION_AUDIT_POINT = {"R": 4, "H": 100.0, "K": 256.0, "W": 32.0}

#: Forms whose provenance must carry the relation symbol ``graph.R`` —
#: a typed-graph form that drops its R multiplicity is wrong even if its
#: units still reduce (the §17 extension of the provenance contract).
_REQUIRES_R_SYMBOL = ("relationalhalo", "relationalhandoff")

_COMPOSITION_CACHE: dict[tuple, SpecAudit] = {}


def audit_composition_forms(*, envelope: Optional[Mapping[str, tuple]] = None,
                            use_cache: bool = True) -> SpecAudit:
    """Audit the composition-layer closed forms like a pseudo-dataflow.

    The relational / episode evaluations charge movement terms that no
    registered :class:`MovementSpec` owns (exact halo reload, resident
    hand-off, minibatch gather).  ``repro_torch.core.compose.COMPOSITION_FORMS``
    restates them over the declared
    :class:`~repro_torch.core.notation.RelationalScheduleParams` x
    :class:`~repro_torch.core.notation.CompositionHardwareParams` records; this
    pass traces each exactly like a Table III/IV movement — units must
    reduce to ``bits^1`` / ``bits^0``, the 2^53 interval propagates the
    relation-count (R) multiplicity, and the relational forms must read
    the ``graph.R`` symbol (dropping the multiplicity is a strict error,
    not just a smaller number).  Returns a :class:`SpecAudit` named
    ``"composition"`` so the CLI report, ``--strict`` gate, and
    provenance table handle it uniformly.
    """
    key = _envelope_key(envelope)
    if use_cache and key in _COMPOSITION_CACHE:
        _CACHE_STATS["hits"] += 1
        return _COMPOSITION_CACHE[key]
    if use_cache:
        _CACHE_STATS["misses"] += 1

    from ..core.compose import COMPOSITION_FORMS
    from ..core.notation import (CompositionHardwareParams,
                                 RelationalScheduleParams)

    base_graph = RelationalScheduleParams(**COMPOSITION_AUDIT_POINT)
    base_hw = CompositionHardwareParams()
    audits = []
    used_symbols: set[str] = set()
    for name, form in COMPOSITION_FORMS:
        role, hierarchy = _COMPOSITION_TERM_INFO.get(name, ("other", "L2-L1"))
        ctx = TraceContext(movement=f"composition.{name}")
        tg = traced_record(base_graph, "graph", ctx, overrides=envelope)
        th = traced_record(base_hw, "hw", ctx)
        trace_error = None
        bits_unit = iters_unit = "untraced"
        symbols: tuple[str, ...] = ()
        bits_bound = iters_bound = float("nan")
        try:
            bits, iters = trace_form(form, tg, th, ctx,
                                     movement=f"composition.{name}")
        except TraceAbort as e:
            trace_error = str(e)
        except Exception as e:
            trace_error = (f"composition.{name}: tracer raised "
                           f"{type(e).__name__}: {e}")
        else:
            bits_unit, iters_unit = str(bits.unit), str(iters.unit)
            if not bits.unit.is_bits:
                ctx.issue("data_bits", f"reduces to {bits.unit}, expected "
                                       f"bits (a count x count product is "
                                       f"not data movement)")
            if not iters.unit.is_dimensionless:
                ctx.issue("iterations", f"reduces to {iters.unit}, "
                                        f"expected dimensionless")
            symbols = tuple(sorted(bits.symbols | iters.symbols))
            if name in _REQUIRES_R_SYMBOL and "graph.R" not in symbols:
                ctx.issue("provenance",
                          "relational form never reads graph.R — the "
                          "relation multiplicity has been dropped")
            bits_bound, iters_bound = bits.hi, iters.hi
        try:
            vb = float(np.asarray(form(base_graph, base_hw)[0]))
            vi = float(np.asarray(form(base_graph, base_hw)[1]))
        except Exception:
            vb = vi = float("nan")
        audits.append(MovementAudit(
            movement=name, role=role, hierarchy=hierarchy,
            bits_unit=bits_unit, iters_unit=iters_unit, symbols=symbols,
            unit_issues=tuple(ctx.issues), waived=False, audit_note=None,
            overflows=tuple(ctx.overflows),
            minimum_calls=ctx.minimum_calls, trace_error=trace_error,
            bits_bound=bits_bound, iters_bound=iters_bound,
            value_bits=vb, value_iters=vi))
        used_symbols.update(symbols)

    used_hw = {s.split(".", 1)[1] for s in used_symbols
               if s.startswith("hw.")}
    used_graph = {s.split(".", 1)[1] for s in used_symbols
                  if s.startswith("graph.")}
    hw_fields = {f.name for f in dataclasses.fields(base_hw)}
    graph_fields = {f.name for f in dataclasses.fields(base_graph)}
    report = SpecAudit(
        name="composition", movements=tuple(audits),
        dead_hw=tuple(sorted(hw_fields - used_hw)), waived_dead_hw=(),
        unused_graph=tuple(sorted(graph_fields - used_graph)),
        golden_expected=None, golden_actual=None, envelope=key)
    if use_cache:
        _COMPOSITION_CACHE[key] = report
    return report


# -- provenance rendering ---------------------------------------------------

def _units_cell(m: MovementAudit) -> str:
    if m.trace_error:
        return "UNTRACED"
    if m.unit_issues and m.waived:
        return f"waived ({len(m.unit_issues)})"
    if m.unit_issues:
        return f"ERROR ({len(m.unit_issues)})"
    return "ok"


def render_provenance(audits: Mapping[str, SpecAudit]) -> str:
    """The symbol-provenance table as deterministic markdown.

    This exact text is committed as the DESIGN.md §16 appendix; the CLI's
    ``--provenance --check`` drift gate re-renders and compares it.
    """
    lines = [
        "| dataflow | movement | role | hierarchy | graph symbols "
        "| hw symbols | units |",
        "|---|---|---|---|---|---|---|",
    ]
    for name in sorted(audits):
        a = audits[name]
        for m in a.movements:
            lines.append(
                f"| {a.name} | {m.movement} | {m.role} | {m.hierarchy} "
                f"| {', '.join(m.graph_symbols) or '—'} "
                f"| {', '.join(m.hw_symbols) or '—'} "
                f"| {_units_cell(m)} |")
    notes = []
    for name in sorted(audits):
        a = audits[name]
        bits = []
        if a.waived_dead_hw:
            bits.append("unused hw (waived): "
                        + ", ".join(a.waived_dead_hw))
        if a.dead_hw:
            bits.append("DEAD hw: " + ", ".join(a.dead_hw))
        if a.unused_graph:
            bits.append("graph symbols not read: "
                        + ", ".join(a.unused_graph))
        if a.waived_issue_count:
            waived = [m.movement for m in a.movements
                      if m.waived and m.unit_issues]
            bits.append(f"unit waivers in {', '.join(waived)}")
        if bits:
            notes.append(f"- **{a.name}**: " + "; ".join(bits))
    if notes:
        lines.append("")
        lines.extend(notes)
    return "\n".join(lines) + "\n"
