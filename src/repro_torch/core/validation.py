"""The Sec. IV golden totals, the registry crosscheck and the traffic
validation (a copy of the reference's ``repro/core/validation.py``).

The reference's ``measured_collective_bytes`` and ``validate_traffic`` read
the collectives out of a compiled program's HLO; here they read a rank's
:class:`repro_torch.distributed.comm.CollectiveLedger`, which records every
collective the rank issued.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "ValidationRecord",
    "SEC4_GOLDEN_TOTALS",
    "validate_dataflow_golden",
    "crosscheck_registry",
    "measured_collective_bytes",
    "validate_traffic",
]

#: Pinned (total_bits, total_iterations) at the paper's Sec. IV defaults
#: (N=30, T=5, K=1024, L=102, P=10240, B=1000, sigma=4): the reference's
#: goldens, which every registry evaluation must reproduce bit for bit.
SEC4_GOLDEN_TOTALS: dict[str, tuple[float, float]] = {
    "engn": (2800200.0, 68.0),
    "hygcn": (2889460.0, 6248.0),
    "spmm_tiled": (5833304.0, 4749.0),
    "spmm_unfused": (6079064.0, 4997.0),
    "awb_gcn": (615680.0, 202.0),
}


@dataclass(frozen=True)
class ValidationRecord:
    name: str
    analytical_bytes: float
    measured_bytes: float

    @property
    def ratio(self) -> float:
        if self.measured_bytes == 0:
            return float("inf") if self.analytical_bytes else 1.0
        return self.analytical_bytes / self.measured_bytes

    def within(self, rel: float) -> bool:
        return abs(self.ratio - 1.0) <= rel

    def __str__(self) -> str:  # pragma: no cover - repr
        return (f"{self.name}: analytical={self.analytical_bytes:.4g}B "
                f"measured={self.measured_bytes:.4g}B ratio={self.ratio:.3f}")


def measured_collective_bytes(ledger):
    """The collective stats of a ledger: the ledger itself, which has the
    reference's ``CollectiveStats`` interface."""
    return ledger


def validate_traffic(name: str, model, ledger, *,
                     static_trip_count: int = 1) -> ValidationRecord:
    """Compare a ``CommModel``'s per-rank ``ici`` bytes with the wire bytes
    of the collectives a rank recorded in ``ledger``.

    ``static_trip_count`` divides the analytical total when the program
    issues the collective once inside a loop of that many trips.
    """
    stats = measured_collective_bytes(ledger)
    return ValidationRecord(
        name=name,
        analytical_bytes=model.total("ici") / max(static_trip_count, 1),
        measured_bytes=stats.total_wire_bytes_per_chip,
    )


def validate_dataflow_golden(name: str) -> ValidationRecord:
    """Registry-evaluated total vs the golden value at Sec. IV defaults; a
    passing record has ratio exactly 1.0."""
    from . import registry
    from .notation import paper_default_graph

    if name not in SEC4_GOLDEN_TOTALS:
        raise KeyError(f"no golden totals recorded for {name!r}; "
                       f"have: {sorted(SEC4_GOLDEN_TOTALS)}")
    out = registry.evaluate(name, paper_default_graph())
    return ValidationRecord(
        name=f"{name}_sec4_golden",
        analytical_bytes=float(out.total_bits()),
        measured_bytes=SEC4_GOLDEN_TOTALS[name][0],
    )


def crosscheck_registry(graph=None, *, conformance: bool = False,
                        conformance_points=None, analysis: bool = False,
                        device=None) -> dict[str, object]:
    """Structural sanity over every registered dataflow at one operating point.

    Evaluates each spec (finite, non-negative bits/iterations are asserted)
    and returns a golden-comparison record where one exists, else None.

    With ``conformance=True``, every dataflow with a runnable kernel
    analogue is also held to its kernel spec by the conformance harness at
    ``conformance_points`` (default: one small point), with the launch
    tensors on ``device`` (CUDA unless ``device="cpu"``).  A failing record
    raises; passing ones are summarized under ``"<name>::conformance"`` as
    analytical-vs-measured HBM-byte totals.

    With ``analysis=True``, every registered spec is also passed through
    the static model auditor (:mod:`repro_torch.analysis`): units,
    symbol provenance, dead hardware parameters and the Sec. IV golden
    pin.  A strict audit error raises; passing audits are stored under
    ``"<name>::analysis"`` as :class:`~repro_torch.analysis.SpecAudit`.
    """
    from . import registry
    from .notation import paper_default_graph

    g = graph if graph is not None else paper_default_graph()
    records: dict[str, ValidationRecord | None] = {}
    for name in registry.names():
        out = registry.evaluate(name, g)
        for t in out.terms:
            if not (np.all(np.isfinite(t.data_bits))
                    and np.all(np.isfinite(t.iterations))):
                raise AssertionError(f"{name}.{t.name}: non-finite movement")
            if np.any(t.data_bits < 0) or np.any(t.iterations < 0):
                raise AssertionError(f"{name}.{t.name}: negative movement")
        records[name] = (validate_dataflow_golden(name)
                         if name in SEC4_GOLDEN_TOTALS else None)
    if conformance:
        from .conformance import CHECK_POINT, conformance_records

        points = (conformance_points if conformance_points is not None
                  else (CHECK_POINT,))
        for name in registry.runnable_names():
            analytical = measured = 0.0
            for pt in points:
                for rec in conformance_records(registry.get(name), pt,
                                               device=device):
                    if not rec.ok:
                        raise AssertionError(f"conformance failure: {rec}")
                    if rec.movement == "hbm_total":
                        analytical += rec.analytical_bytes
                        measured += rec.measured_bytes
            records[f"{name}::conformance"] = ValidationRecord(
                name=f"{name}_conformance_hbm",
                analytical_bytes=analytical, measured_bytes=measured)
    if analysis:
        from ..analysis import audit_spec

        for name in registry.names():
            audit = audit_spec(registry.get(name))
            errors = audit.strict_errors()
            if errors:
                raise AssertionError(
                    f"model audit failure for {name}: " + "; ".join(errors))
            records[f"{name}::analysis"] = audit
    return records
