"""The port's dataflow registry (a copy of the reference's
``repro/core/registry.py``).

It holds the reference's five dataflows, in its order: the paper's
``engn`` and ``hygcn``, the block-dense ``spmm_tiled`` and
``spmm_unfused``, and the column-balanced ``awb_gcn``.  The two spmm
dataflows name the port's kernels as their runnable target; the harness
holds those kernels to the kernel specs ``spmm_tiled_cta`` and
``spmm_unfused_cta``, which :func:`get` resolves but :func:`names` does not
list, so every sweep over the registry has the reference's rows.  A
namespace of its own; the reference registry is never touched.
"""

from __future__ import annotations

from contextlib import contextmanager

from .awb_gcn import AWB_GCN_SPEC
from .dataflow import DataflowSpec, SpecModel
from .engn import ENGN_SPEC
from .hygcn import HYGCN_SPEC
from .spmm_tiled import SPMM_TILED_CTA_SPEC, SPMM_TILED_SPEC
from .spmm_unfused import SPMM_UNFUSED_CTA_SPEC, SPMM_UNFUSED_SPEC
from .terms import ModelOutput

__all__ = ["register", "unregister", "temporarily_registered", "get",
           "names", "specs", "model", "evaluate", "runnable_names"]

_REGISTRY: dict[str, DataflowSpec] = {}

#: The forms the conformance harness holds the kernels to.
_KERNEL_SPECS: dict[str, DataflowSpec] = {
    s.name: s for s in (SPMM_TILED_CTA_SPEC, SPMM_UNFUSED_CTA_SPEC)}


def register(spec: DataflowSpec, *, overwrite: bool = False) -> DataflowSpec:
    """Register a dataflow spec under its own name; returns it for chaining."""
    if not isinstance(spec, DataflowSpec):
        raise TypeError(f"expected DataflowSpec, got {type(spec).__name__}")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"accelerator {spec.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> DataflowSpec:
    """Remove and return a registered spec; KeyError if absent."""
    try:
        return _REGISTRY.pop(name)
    except KeyError:
        raise KeyError(f"cannot unregister unknown accelerator {name!r}; "
                       f"registered: {names()}") from None


@contextmanager
def temporarily_registered(*specs: DataflowSpec, overwrite: bool = False):
    """Register specs for the duration of a ``with`` block, then restore.

    A spec shadowed via ``overwrite=True`` is reinstated on exit; specs
    newly added are removed even if the body already unregistered them.
    """
    shadowed: dict[str, DataflowSpec] = {}
    added: list[str] = []
    try:
        for spec in specs:
            # Record only the first occupant of a name, and register inside
            # the try so that a failure mid-way rolls back what was added.
            if spec.name not in shadowed and spec.name not in added:
                if spec.name in _REGISTRY:
                    if not overwrite:
                        raise ValueError(
                            f"accelerator {spec.name!r} already registered "
                            "(pass overwrite=True to shadow)")
                    shadowed[spec.name] = _REGISTRY[spec.name]
                else:
                    added.append(spec.name)
            register(spec, overwrite=overwrite)
        yield tuple(specs)
    finally:
        for name in added:
            _REGISTRY.pop(name, None)
        _REGISTRY.update(shadowed)


def get(name: str) -> DataflowSpec:
    """A registered dataflow, or one of the kernel specs."""
    spec = _REGISTRY.get(name, _KERNEL_SPECS.get(name))
    if spec is None:
        raise KeyError(f"unknown port dataflow {name!r}; registered: "
                       f"{names()}, kernel specs: {tuple(_KERNEL_SPECS)}")
    return spec


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def specs() -> tuple[DataflowSpec, ...]:
    return tuple(_REGISTRY.values())


def model(name: str) -> SpecModel:
    """A class-API model wrapping the named spec."""
    return SpecModel(get(name))


def evaluate(name: str, graph, hw=None) -> ModelOutput:
    """Resolve + evaluate in one call (the common sweep-engine path)."""
    return get(name).evaluate(graph, hw)


def runnable_names() -> tuple[str, ...]:
    """Registered dataflows whose kernels the conformance harness measures."""
    return tuple(name for name, spec in _REGISTRY.items() if spec.has_runnable)


for _spec in (ENGN_SPEC, HYGCN_SPEC, SPMM_TILED_SPEC, SPMM_UNFUSED_SPEC,
              AWB_GCN_SPEC):
    register(_spec)
del _spec
