"""Parameter-sweep engine reproducing the paper's Figures 3-7 (a copy of the
reference's ``repro/core/sweep.py``).

Every ``figN_*`` function is a thin client of :mod:`repro_torch.api`: it
builds the figure's named scenario template (:mod:`repro_torch.api.
templates`), hands the batch to the planner (one broadcast closed-form
call per dataflow, no Python loop per grid cell), and reshapes the stacked
results onto the figure's grid.  The closed forms are elementwise float64
algebra, so the grids are bit-identical to the reference's.

Each ``figN_*`` mirrors one figure at its Sec. IV defaults (N=30, T=5,
B=1000, sigma=4, P=10K) and returns a :class:`SweepResult` with labelled
axes and a per-term breakdown grid.  :func:`sweep_accelerators` broadcasts
one parameter grid across *every* registered dataflow — one evaluation per
accelerator — and stacks the results along a leading accelerator axis
(:class:`AcceleratorSweepResult`), the comparative study the paper's
Sec. IV narrates for any number of dataflows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from ..api import evaluate_groups, templates, tile_scenarios_from_graph

from . import registry
from .engn import EnGNModel
from .notation import EnGNHardwareParams, GraphTileParams, paper_default_graph
from .terms import CACHE_CLASSES, L1_CLASSES, L2_CLASSES, ModelOutput

__all__ = [
    "SweepResult",
    "AcceleratorSweepResult",
    "sweep_accelerators",
    "fig3_engn_movement",
    "fig4_hygcn_movement",
    "fig5_iterations_vs_bandwidth",
    "fig6_fitting_factor",
    "fig7_systolic_reuse",
    "DEFAULT_K_SWEEP",
    "DEFAULT_M_SWEEP",
    "DEFAULT_B_SWEEP",
]

# The grids live with the templates.
DEFAULT_K_SWEEP = templates.DEFAULT_K_SWEEP
DEFAULT_M_SWEEP = templates.DEFAULT_M_SWEEP
DEFAULT_B_SWEEP = templates.DEFAULT_B_SWEEP


def _flatten_columns(axes: Mapping[str, np.ndarray],
                     columns: Mapping[str, np.ndarray]) -> tuple[list[str], np.ndarray]:
    """One np.stack flatten: (column names, (n_cells, n_cols) float matrix).

    Axis columns come first (meshgrid order), then the value columns
    broadcast to the grid shape and raveled.
    """
    names = list(axes)
    grids = np.meshgrid(*[axes[n] for n in names], indexing="ij")
    shape = grids[0].shape if grids else ()
    cols = names + list(columns)
    mat = np.stack(
        [g.ravel() for g in grids]
        + [np.broadcast_to(np.asarray(v, np.float64), shape).ravel()
           for v in columns.values()],
        axis=1,
    )
    return cols, mat


@dataclass(frozen=True)
class SweepResult:
    """A labelled sweep: ``axes`` name the grid dims of every value array."""

    figure: str
    axes: Mapping[str, np.ndarray]
    data_bits: Mapping[str, np.ndarray]        # per movement level
    iterations: Mapping[str, np.ndarray]       # per movement level
    meta: Mapping[str, object] = field(default_factory=dict)

    @property
    def total_bits(self) -> np.ndarray:
        return sum(self.data_bits.values())

    @property
    def total_iterations(self) -> np.ndarray:
        return sum(self.iterations.values())

    def rows(self) -> list[dict[str, float]]:
        """Flatten to records — the benchmark harness prints these as CSV."""
        columns = {"total_bits": self.total_bits,
                   "total_iterations": self.total_iterations}
        columns.update({f"bits_{term}": arr for term, arr in self.data_bits.items()})
        cols, mat = _flatten_columns(self.axes, columns)
        return [dict(zip(cols, row)) for row in mat.tolist()]


@dataclass(frozen=True)
class AcceleratorSweepResult:
    """A sweep stacked across accelerators: arrays have shape (A, *grid).

    ``total_bits`` / ``total_iterations`` / the per-hierarchy-class maps all
    carry a leading axis indexed by ``accelerators``; a row dump tags each
    record with its accelerator name.
    """

    figure: str
    accelerators: tuple[str, ...]
    axes: Mapping[str, np.ndarray]
    total_bits: np.ndarray
    total_iterations: np.ndarray
    class_bits: Mapping[str, np.ndarray]   # offchip / cache / onchip -> (A, *grid)
    meta: Mapping[str, object] = field(default_factory=dict)

    def accelerator_index(self, name: str) -> int:
        return self.accelerators.index(name)

    def rows(self) -> list[dict[str, object]]:
        out: list[dict[str, object]] = []
        for a, name in enumerate(self.accelerators):
            columns = {"total_bits": self.total_bits[a],
                       "total_iterations": self.total_iterations[a]}
            columns.update({f"bits_{cls}": arr[a]
                            for cls, arr in self.class_bits.items()})
            cols, mat = _flatten_columns(self.axes, columns)
            out.extend({"accelerator": name, **dict(zip(cols, row))}
                       for row in mat.tolist())
        return out


def _sweep_result_from_template(tb: "templates.TemplateBatch",
                                **extra_meta) -> SweepResult:
    """Evaluate a figure template and reshape the stacked output to its grid.

    A figure template is one plan group (one dataflow, one override-key
    set), so the planner performs exactly one broadcast evaluation; each
    movement term's batch column C-reshapes onto the meshgrid ``ij`` grid.
    """
    (group,) = evaluate_groups(tb.scenarios)
    out = group.output
    shape = tb.grid_shape
    n = len(tb.scenarios)

    def grid(arr) -> np.ndarray:
        return np.broadcast_to(np.asarray(arr, np.float64), (n,)).reshape(shape)

    return SweepResult(
        figure=tb.figure,
        axes={k: np.asarray(v, np.float64) for k, v in tb.axes.items()},
        data_bits={t.name: grid(t.data_bits) for t in out.terms},
        iterations={t.name: grid(t.iterations) for t in out.terms},
        meta={**dict(tb.meta), **extra_meta},
    )


def sweep_accelerators(
    accelerators: Sequence[str] | None = None,
    K: np.ndarray = DEFAULT_K_SWEEP,
    *,
    graph: GraphTileParams | None = None,
    axes: Mapping[str, np.ndarray] | None = None,
    figure: str = "sweep_accelerators",
) -> AcceleratorSweepResult:
    """Evaluate every (registered) accelerator over one grid, stacked.

    The grid flattens to a scenario batch (one scenario per accelerator
    per cell) and the planner evaluates each dataflow **once** on the
    whole stacked batch; the per-accelerator totals are then reshaped and
    ``np.stack``-ed along a leading accelerator axis.  Pass ``graph`` to
    sweep a custom array-valued tile instead of the Sec. IV defaults; when
    exactly one graph field is array-valued the sweep axis is inferred,
    otherwise label the grid explicitly via ``axes`` (meshgrid ``ij``
    order, like :class:`SweepResult`).
    """
    names = tuple(accelerators) if accelerators is not None else registry.names()
    K = np.atleast_1d(np.asarray(K, np.float64))
    g = graph if graph is not None else paper_default_graph(K)
    shape = np.broadcast_shapes(*(np.shape(v) for v in g.astuple_f64()))
    if graph is None:
        axes = {"K": K}
    elif axes is None:
        arr_fields = {f: np.asarray(getattr(g, f), np.float64)
                      for f in ("N", "T", "K", "L", "P")
                      if np.ndim(getattr(g, f)) == 1}
        if len(arr_fields) != 1:
            raise ValueError(
                "cannot infer the sweep axes of a custom graph with "
                f"{len(arr_fields)} 1-D array-valued fields; pass axes= "
                "naming the grid explicitly")
        axes = arr_fields
    grid_shape = tuple(len(np.atleast_1d(v)) for v in axes.values())
    if grid_shape != shape:
        raise ValueError(f"axes grid shape {grid_shape} does not match the "
                         f"graph broadcast shape {shape}")
    # dict.fromkeys: dedupe while preserving order — a repeated name costs
    # one evaluation and reuses the stacked output for every occurrence.
    scenarios = [s for name in dict.fromkeys(names)
                 for s in tile_scenarios_from_graph(name, g, shape)]
    groups = evaluate_groups(scenarios)
    outputs: dict[str, ModelOutput] = {grp.dataflow: grp.output
                                       for grp in groups}
    assert len(groups) == len(set(names)), "one broadcast call per dataflow"
    n = int(np.prod(shape)) if shape else 1

    def stack(fn):
        return np.stack([
            np.broadcast_to(np.asarray(fn(outputs[name]), np.float64),
                            (n,)).reshape(shape)
            for name in names])

    return AcceleratorSweepResult(
        figure=figure,
        accelerators=names,
        axes={k: np.atleast_1d(np.asarray(v, np.float64))
              for k, v in axes.items()},
        total_bits=stack(lambda o: o.total_bits()),
        total_iterations=stack(lambda o: o.total_iterations()),
        class_bits={
            "offchip": stack(lambda o: o.total_bits(L2_CLASSES)),
            "cache": stack(lambda o: o.total_bits(CACHE_CLASSES)),
            "onchip": stack(lambda o: o.total_bits(L1_CLASSES)),
        },
        meta={"outputs": tuple(outputs[name] for name in names),
              "n_evaluations": len(groups)},
    )


def fig3_engn_movement(
    K: np.ndarray = DEFAULT_K_SWEEP,
    M: np.ndarray = DEFAULT_M_SWEEP,
) -> SweepResult:
    """Fig. 3: EnGN per-level data movement across tile size and PE array.

    The paper plots M = M' ("for the sake of clarity"); we sweep both equal.
    """
    return _sweep_result_from_template(templates.fig3(K=K, M=M))


def fig4_hygcn_movement(
    K: np.ndarray = DEFAULT_K_SWEEP,
    Ma: np.ndarray = DEFAULT_M_SWEEP,
) -> SweepResult:
    """Fig. 4: HyGCN per-level data movement across tile size and SIMD cores."""
    return _sweep_result_from_template(templates.fig4(K=K, Ma=Ma))


def fig5_iterations_vs_bandwidth(
    accelerator: str,
    B: np.ndarray = DEFAULT_B_SWEEP,
    K: np.ndarray = np.array([256, 1024, 4096], dtype=np.float64),
) -> SweepResult:
    """Fig. 5(a)/(b): total iterations vs memory bandwidth per workload size.

    Any registered accelerator works — every hardware record has a ``B``
    (L2 bandwidth) field to sweep.
    """
    return _sweep_result_from_template(templates.fig5(accelerator, B=B, K=K))


def fig6_fitting_factor(
    K: float = 1024.0,
    M: np.ndarray = np.array([4, 8, 16, 32, 64, 128, 256, 512], dtype=np.float64),
) -> SweepResult:
    """Fig. 6: EnGN iterations vs the array-fitting factor K*N / M^2."""
    M = np.asarray(M, np.float64)
    ff = EnGNModel().fitting_factor(paper_default_graph(K),
                                    EnGNHardwareParams(M=M, M_prime=M))
    return _sweep_result_from_template(templates.fig6(K=K, M=M),
                                       fitting_factor=ff)


def fig7_systolic_reuse(
    gamma: np.ndarray = np.linspace(0.0, 0.99, 34),
    N: np.ndarray = np.array([30, 128, 512], dtype=np.float64),
) -> SweepResult:
    """Fig. 7: HyGCN loadweights movement vs systolic reuse Gamma and depth N."""
    return _sweep_result_from_template(templates.fig7(gamma=gamma, N=N))
