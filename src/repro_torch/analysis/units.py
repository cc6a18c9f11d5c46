"""Unit algebra for the model auditor (DESIGN.md §16).

The paper's movement models follow an *iteration-granular* convention
(Table II): ``B`` is the number of bits one iteration can move, so
``bits`` and ``bits/iter`` quantities are directly comparable inside the
capacity operator ``min(K*sigma, M*sigma, B)`` — both reduce to the single
``bits`` dimension.  Counts (``elements``, ``vertices``, ``edges``,
``PEs``) are dimensionless multipliers under this convention.  The payoff
is a one-dimensional algebra with teeth:

* a valid ``data_bits`` closed form must reduce to ``bits^1``,
* a valid ``iterations`` closed form must reduce to ``bits^0``,
* ``min`` / ``max`` / ``+`` / ``-`` / ``where`` require equal exponents,
* ``ceil`` / ``floor`` require a dimensionless operand (they are applied
  to occupancy *ratios*), and
* dropping a ``sigma`` factor, or multiplying two bits-carrying
  quantities, breaks the reduction and is a hard audit failure
  ("count x count products are not bits").

The *nominal* tag (``elements`` vs ``PEs`` vs ``vertices``) does not enter
the algebra — the paper freely multiplies vertex counts by per-vertex
element counts — but it is preserved on seeded symbols for the provenance
table.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Unit", "BITS", "DIMENSIONLESS", "UNIT_TAGS", "unit_from_tag"]

#: The recognized Table II unit tags (see notation.FieldUnit).
#: ``relations`` is this repo's extension for the typed-graph relation
#: count R (DESIGN.md §17) — a count, hence dimensionless in the algebra.
UNIT_TAGS = ("bits", "bits/iter", "elements", "vertices", "edges", "PEs",
             "relations", "dimensionless")


@dataclass(frozen=True)
class Unit:
    """A unit as an integer exponent of the ``bits`` dimension."""

    bits_exp: int = 0

    def __mul__(self, other: "Unit") -> "Unit":
        return Unit(self.bits_exp + other.bits_exp)

    def __truediv__(self, other: "Unit") -> "Unit":
        return Unit(self.bits_exp - other.bits_exp)

    def __pow__(self, k: int) -> "Unit":
        return Unit(self.bits_exp * int(k))

    @property
    def is_dimensionless(self) -> bool:
        return self.bits_exp == 0

    @property
    def is_bits(self) -> bool:
        return self.bits_exp == 1

    def __str__(self) -> str:
        if self.bits_exp == 0:
            return "dimensionless"
        if self.bits_exp == 1:
            return "bits"
        return f"bits^{self.bits_exp}"


BITS = Unit(1)
DIMENSIONLESS = Unit(0)


def unit_from_tag(tag: str) -> Unit:
    """Map a declared Table II unit tag to its algebraic reduction."""
    if tag not in UNIT_TAGS:
        raise ValueError(f"unknown unit tag {tag!r}; expected one of "
                         f"{UNIT_TAGS}")
    return BITS if tag in ("bits", "bits/iter") else DIMENSIONLESS
