"""Static model auditor for the movement-level closed forms (DESIGN.md §16;
a copy of the reference's ``repro/analysis``, NumPy only).

Two engines, importable as a library and runnable as a CLI
(``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.audit` — a symbolic tracer that runs every
  registered ``MovementSpec.form`` on unit-tagged, interval-bounded
  tracer records and derives dimensional consistency, symbol provenance
  (with dead-hardware detection), and a float64-exactness audit against
  the 10^9-edge / 10^7-vertex operating envelope.
* :mod:`repro_torch.analysis.lint` — an AST linter over ``repro_torch.core``
  enforcing closed-form and trace-path idioms
  (no builtin ``min``/``max``/``math.ceil`` in forms, no ``np.lexsort``
  or edge-list materialization in trace paths, literal MovementSpec
  vocabularies).

A mutation battery (:mod:`repro_torch.analysis.mutations`) injects realistic
transcription errors and asserts the auditor catches every one.
"""

from .audit import (DEFAULT_ENVELOPE, MovementAudit, SpecAudit,
                    analysis_cache_info, audit_composition_forms,
                    audit_registry, audit_spec, clear_analysis_cache,
                    render_provenance)
from .lint import LintViolation, default_lint_roots, lint_paths, lint_source
from .mutations import (Mutant, MutationOutcome, mutate_spec,
                        run_mutation_battery)
from .tracer import (FLOAT64_EXACT_MAX, OverflowRecord, SymbolicValue,
                     TraceAbort, TraceContext, UnitIssue, trace_form,
                     traced_record)
from .units import BITS, DIMENSIONLESS, UNIT_TAGS, Unit, unit_from_tag

__all__ = [
    "Unit", "BITS", "DIMENSIONLESS", "UNIT_TAGS", "unit_from_tag",
    "SymbolicValue", "TraceContext", "TraceAbort", "UnitIssue",
    "OverflowRecord", "FLOAT64_EXACT_MAX", "traced_record", "trace_form",
    "MovementAudit", "SpecAudit", "audit_spec", "audit_registry",
    "audit_composition_forms", "analysis_cache_info",
    "clear_analysis_cache", "render_provenance",
    "DEFAULT_ENVELOPE",
    "LintViolation", "lint_source", "lint_paths", "default_lint_roots",
    "Mutant", "MutationOutcome", "mutate_spec", "run_mutation_battery",
]
