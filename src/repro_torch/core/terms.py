"""Movement-term algebra of the closed forms (a copy of the reference's).

A dataflow is a list of *movement levels*, each with an amount of data
movement in bits, a number of iterations, and the memory-hierarchy levels
the traffic crosses.  On the H100 ``L2`` is device memory and its L2 cache,
``L1`` a CTA's registers and shared memory, and ``L1-L1`` traffic stays on
the SM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

__all__ = ["ceil", "minimum", "MovementTerm", "ModelOutput",
           "AcceleratorModel", "tabulate", "L2_CLASSES", "L1_CLASSES",
           "CACHE_CLASSES"]

L2_CLASSES = ("L2-L1", "L1-L2")
CACHE_CLASSES = ("L2*-L1", "L1-L2*")
L1_CLASSES = ("L1-L1",)
_VALID_HIERARCHIES = frozenset(L2_CLASSES + CACHE_CLASSES + L1_CLASSES)


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def ceil(x) -> np.ndarray:
    """Exact ceiling in float64 (all operands in the models are integral)."""
    return np.ceil(_f64(x))


def minimum(*xs) -> np.ndarray:
    """Variadic broadcasting minimum — the capacity-constraint operator."""
    out = _f64(xs[0])
    for x in xs[1:]:
        out = np.minimum(out, _f64(x))
    return out


@dataclass(frozen=True)
class MovementTerm:
    """One movement level: bits and iterations, broadcasting together."""

    name: str
    hierarchy: str
    data_bits: np.ndarray
    iterations: np.ndarray

    def __post_init__(self) -> None:
        if self.hierarchy not in _VALID_HIERARCHIES:
            raise ValueError(
                f"unknown hierarchy {self.hierarchy!r} for term {self.name!r}; "
                f"expected one of {sorted(_VALID_HIERARCHIES)}"
            )
        object.__setattr__(self, "data_bits", _f64(self.data_bits))
        object.__setattr__(self, "iterations", _f64(self.iterations))


@dataclass(frozen=True)
class ModelOutput:
    """Evaluated model: the full movement-level breakdown for one dataflow."""

    accelerator: str
    terms: tuple[MovementTerm, ...]
    meta: Mapping[str, object] = field(default_factory=dict)

    def __getitem__(self, name: str) -> MovementTerm:
        for t in self.terms:
            if t.name == name:
                return t
        raise KeyError(f"{self.accelerator} model has no term {name!r}; "
                       f"available: {[t.name for t in self.terms]}")

    def names(self) -> list[str]:
        return [t.name for t in self.terms]

    def select(self, hierarchies: Sequence[str] | None = None
               ) -> tuple[MovementTerm, ...]:
        if hierarchies is None:
            return self.terms
        keep = frozenset(hierarchies)
        return tuple(t for t in self.terms if t.hierarchy in keep)

    def total_bits(self, hierarchies: Sequence[str] | None = None
                   ) -> np.ndarray:
        terms = self.select(hierarchies)
        return sum((t.data_bits for t in terms), start=_f64(0.0))

    def total_iterations(self, hierarchies: Sequence[str] | None = None
                         ) -> np.ndarray:
        terms = self.select(hierarchies)
        return sum((t.iterations for t in terms), start=_f64(0.0))

    def scaled(self, factor) -> "ModelOutput":
        """Every term's bits and iterations multiplied by ``factor`` (the
        composition layer repeats a per-tile evaluation over a schedule)."""
        f = _f64(factor)
        return ModelOutput(
            accelerator=self.accelerator,
            terms=tuple(MovementTerm(t.name, t.hierarchy,
                                     t.data_bits * f, t.iterations * f)
                        for t in self.terms),
            meta=self.meta,
        )

    def breakdown(self) -> dict[str, np.ndarray]:
        return {t.name: t.data_bits for t in self.terms}

    def iteration_breakdown(self) -> dict[str, np.ndarray]:
        return {t.name: t.iterations for t in self.terms}

    def offchip_bits(self) -> np.ndarray:
        return self.total_bits(L2_CLASSES)

    def cache_bits(self) -> np.ndarray:
        return self.total_bits(CACHE_CLASSES)

    def onchip_bits(self) -> np.ndarray:
        return self.total_bits(L1_CLASSES)


class AcceleratorModel:
    """Base class: an analytical data-movement model of one accelerator,
    ``evaluate(graph, hw) -> ModelOutput``; closed forms broadcast."""

    name: str = "abstract"

    def evaluate(self, graph, hw) -> ModelOutput:  # pragma: no cover - interface
        raise NotImplementedError

    def total_bits(self, graph, hw, hierarchies=None) -> np.ndarray:
        return self.evaluate(graph, hw).total_bits(hierarchies)

    def total_iterations(self, graph, hw, hierarchies=None) -> np.ndarray:
        return self.evaluate(graph, hw).total_iterations(hierarchies)


def tabulate(output: ModelOutput, *, scalar_fmt: str = "{:>14.4g}") -> str:
    """Render a ModelOutput of scalar terms as the paper's table layout."""
    rows = [f"{'movement level':<18}{'data movement [bits]':>22}"
            f"{'iterations':>14}  hierarchy"]
    for t in output.terms:
        bits = np.asarray(t.data_bits)
        iters = np.asarray(t.iterations)
        if bits.ndim == 0:
            rows.append(
                f"{t.name:<18}{scalar_fmt.format(float(bits)):>22}"
                f"{scalar_fmt.format(float(iters)):>14}  {t.hierarchy}"
            )
        else:
            rows.append(f"{t.name:<18}{'<array sweep>':>22}"
                        f"{'<array sweep>':>14}  {t.hierarchy}")
    return "\n".join(rows)
