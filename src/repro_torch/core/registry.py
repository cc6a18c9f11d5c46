"""The port's dataflow registry: the two specs its kernels are held to.

A namespace of its own; the reference registry is never touched.
"""

from __future__ import annotations

from .dataflow import DataflowSpec
from .spmm_tiled import SPMM_TILED_CTA_SPEC
from .spmm_unfused import SPMM_UNFUSED_CTA_SPEC

__all__ = ["get", "names"]

_SPECS: dict[str, DataflowSpec] = {
    s.name: s for s in (SPMM_TILED_CTA_SPEC, SPMM_UNFUSED_CTA_SPEC)}


def get(name: str) -> DataflowSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown port dataflow {name!r}; registered: "
                       f"{names()}") from None


def names() -> list[str]:
    return list(_SPECS)
