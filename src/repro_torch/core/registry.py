"""The port's dataflow registry.

It holds the paper's two dataflows (``engn``, ``hygcn``), the column-balanced
``awb_gcn``, and the two specs the port's kernels are held to
(``spmm_tiled_cta``, ``spmm_unfused_cta``).  A namespace of its own; the
reference registry is never touched.
"""

from __future__ import annotations

from .awb_gcn import AWB_GCN_SPEC
from .dataflow import DataflowSpec
from .engn import ENGN_SPEC
from .hygcn import HYGCN_SPEC
from .spmm_tiled import SPMM_TILED_CTA_SPEC
from .spmm_unfused import SPMM_UNFUSED_CTA_SPEC

__all__ = ["get", "names", "runnable_names"]

_SPECS: dict[str, DataflowSpec] = {
    s.name: s for s in (ENGN_SPEC, HYGCN_SPEC, AWB_GCN_SPEC,
                        SPMM_TILED_CTA_SPEC, SPMM_UNFUSED_CTA_SPEC)}


def get(name: str) -> DataflowSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown port dataflow {name!r}; registered: "
                       f"{names()}") from None


def names() -> list[str]:
    return list(_SPECS)


def runnable_names() -> list[str]:
    """The dataflows whose kernels the conformance harness measures."""
    return [name for name, spec in _SPECS.items() if spec.has_runnable]
