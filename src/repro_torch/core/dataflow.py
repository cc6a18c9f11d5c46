"""Declarative dataflow layer (a copy of the reference's ``MovementSpec``,
``DataflowSpec`` and ``SpecModel``): an accelerator as an ordered tuple of
movement levels, each a closed form ``(graph, hw) -> (data_bits,
iterations)``, evaluated by one shared engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

from .terms import AcceleratorModel, ModelOutput, MovementTerm

__all__ = ["MovementSpec", "DataflowSpec", "SpecModel", "MOVEMENT_ROLES"]

#: What a movement level's traffic carries.
MOVEMENT_ROLES = (
    "vertex_in",    # loads input vertex features into the array
    "vertex_out",   # writes output vertex features back out
    "edges",        # streams graph topology (edge lists / adjacency blocks)
    "weights",      # loads model weights
    "compute",      # on-array traffic of the compute stages
    "interphase",   # traffic through an intermediate (inter-phase) buffer
    "other",
)

#: Closed form of one movement level: (graph, hw) -> (data_bits, iterations).
MovementForm = Callable[[object, object], Tuple[np.ndarray, np.ndarray]]


@dataclass(frozen=True)
class MovementSpec:
    """One movement level of a dataflow, as a declarative record.

    ``audit_note`` is a unit-audit waiver: when set, the model auditor
    (:mod:`repro_torch.analysis`) reports this movement's unit findings as
    *waived* instead of failing ``--strict``.  It exists for paper-verbatim
    transcriptions whose published forms mix units (the HyGCN Table IV
    rows); the note must say which table row is being transcribed and why
    the finding is expected.
    """

    name: str
    hierarchy: str
    form: MovementForm
    role: str = "other"
    audit_note: str | None = None

    def __post_init__(self) -> None:
        if self.role not in MOVEMENT_ROLES:
            raise ValueError(
                f"unknown role {self.role!r} for movement {self.name!r}; "
                f"expected one of {MOVEMENT_ROLES}"
            )

    def term(self, graph, hw) -> MovementTerm:
        bits, iterations = self.form(graph, hw)
        return MovementTerm(self.name, self.hierarchy, bits, iterations)

    def interior_at(self, layer: int, n_layers: int) -> bool:
        """Whether this movement carries an inter-layer activation: a
        ``vertex_out`` before the last layer or a ``vertex_in`` after the
        first, the traffic a ``"resident"`` policy keeps on-array."""
        return ((self.role == "vertex_out" and layer < n_layers - 1)
                or (self.role == "vertex_in" and layer > 0))


@dataclass(frozen=True)
class DataflowSpec:
    """A complete accelerator dataflow: ordered movement levels + defaults.

    ``runnable`` is the conformance hook: a zero-argument factory returning
    the kernel analogue (see :mod:`repro_torch.core.conformance`) whose
    traffic is held to these closed forms.

    ``unused_hw`` waives the model auditor's dead-hardware-parameter check
    for declared Table II fields that no movement form reads, e.g. EnGN's
    ``M_prime``, which enters only the fitting-factor diagnostic, not any
    movement.  Every entry is a recorded decision the provenance table
    surfaces; an *undeclared* dead parameter fails ``python -m
    repro_torch.analysis --strict``.
    """

    name: str
    movements: tuple[MovementSpec, ...]
    hw_factory: Callable[[], object]
    description: str = ""
    runnable: Callable[[], object] | None = None
    unused_hw: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        names = [m.name for m in self.movements]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate movement names in spec {self.name!r}: {names}")

    def resolve_hw(self, hw=None):
        return self.hw_factory() if hw is None else hw

    def evaluate(self, graph, hw=None) -> ModelOutput:
        """The shared engine: run every movement form and assemble the output."""
        hw = self.resolve_hw(hw)
        terms = tuple(m.term(graph, hw) for m in self.movements)
        return ModelOutput(accelerator=self.name, terms=terms,
                           meta={"hw": hw, "graph": graph, "spec": self})

    @property
    def has_runnable(self) -> bool:
        return self.runnable is not None

    def runnable_analogue(self):
        """Instantiate the registered kernel analogue (conformance hook)."""
        if self.runnable is None:
            raise ValueError(f"dataflow {self.name!r} declares no runnable "
                             "kernel analogue (runnable=None)")
        return self.runnable()


class SpecModel(AcceleratorModel):
    """Class-API adapter: an :class:`AcceleratorModel` backed by a spec
    (the composition layer wraps a bare spec in one)."""

    spec: DataflowSpec

    def __init__(self, spec: DataflowSpec | None = None) -> None:
        if spec is not None:
            self.spec = spec
        if not isinstance(getattr(self, "spec", None), DataflowSpec):
            raise TypeError(f"{type(self).__name__} has no DataflowSpec bound")
        self.name = self.spec.name

    def evaluate(self, graph, hw=None) -> ModelOutput:
        return self.spec.evaluate(graph, hw)
