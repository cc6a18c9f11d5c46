"""Closed forms, the composition layer, the exact-trace scheduler and the
conformance harness of the port.

* :mod:`.registry` — the reference's five dataflows by name (``engn``,
  ``hygcn``, ``spmm_tiled``, ``spmm_unfused``, ``awb_gcn``), plus the
  kernel specs ``spmm_tiled_cta`` / ``spmm_unfused_cta``;
* :mod:`.compose` — ``MultiLayerModel``, ``TiledGraphModel`` and
  ``RelationalGraphModel``, and the auditable ``COMPOSITION_FORMS``;
* :mod:`.trace` — exact edge-list tile schedules of plain and typed
  traces, counted by kernel K4, and :mod:`.schedule_cache`, their
  content-addressed disk cache;
* :mod:`.tune` — the design-space tuner: the movement-minimizing
  (dataflow, tile capacity, residency, halo policy) under an SRAM budget,
  and the Pareto frontier;
* :mod:`.sweep` — the paper's Figures 3-7 and the stacked all-dataflow
  sweep (imported on its own: it is a client of :mod:`repro_torch.api`);
* :mod:`.validation` — the Sec. IV golden totals and the registry
  crosscheck;
* :mod:`.conformance` — the kernels' byte schedules held to their closed
  forms, behind the static model auditor's preflight
  (:mod:`repro_torch.analysis`).
"""

from . import registry
from .awb_gcn import AWBGCNModel, AWB_GCN_SPEC
from .compose import (COMPOSITION_FORMS, FullGraphParams, MultiLayerModel,
                      RESIDENCY_POLICIES, RelationalGraphModel,
                      TiledGraphModel, tile_working_set_bits)
from .conformance import (ConformanceRecord, OperatingPoint,
                          default_operating_points, run_conformance,
                          summarize_records)
from .dataflow import DataflowSpec, MovementSpec, SpecModel, MOVEMENT_ROLES
from .engn import ENGN_SPEC, EnGNModel
from .hygcn import HYGCN_SPEC, HyGCNModel
from .notation import (AWBGCNHardwareParams, CompositionHardwareParams,
                       EnGNHardwareParams, GraphTileParams,
                       HyGCNHardwareParams, PAPER_DEFAULT_ENGN,
                       PAPER_DEFAULT_GRAPH, PAPER_DEFAULT_HYGCN,
                       RelationalScheduleParams, TiledSpMMHardwareParams,
                       paper_default_graph)
from .spmm_tiled import SPMM_TILED_SPEC, TiledSpMMModel
from .spmm_unfused import SPMM_UNFUSED_SPEC, UnfusedSpMMModel
from .terms import (AcceleratorModel, CACHE_CLASSES, L1_CLASSES, L2_CLASSES,
                    ModelOutput, MovementTerm, tabulate)
from .trace import (GraphTrace, TraceSchedule, TypedGraphTrace,
                    clear_trace_cache, register_trace_dataset,
                    reset_trace_stats, resolve_trace_dataset,
                    trace_cache_info, trace_dataset_names)
from .tune import (InfeasibleBudgetError, TunePoint, TuneResult,
                   normalize_optimize, tune_scenario)

__all__ = [
    "DataflowSpec",
    "MovementSpec",
    "SpecModel",
    "MOVEMENT_ROLES",
    "registry",
    "EnGNModel",
    "HyGCNModel",
    "TiledSpMMModel",
    "UnfusedSpMMModel",
    "AWBGCNModel",
    "ENGN_SPEC",
    "HYGCN_SPEC",
    "SPMM_TILED_SPEC",
    "SPMM_UNFUSED_SPEC",
    "AWB_GCN_SPEC",
    "ConformanceRecord",
    "OperatingPoint",
    "default_operating_points",
    "run_conformance",
    "summarize_records",
    "MultiLayerModel",
    "TiledGraphModel",
    "RelationalGraphModel",
    "COMPOSITION_FORMS",
    "FullGraphParams",
    "RESIDENCY_POLICIES",
    "tile_working_set_bits",
    "GraphTrace",
    "TypedGraphTrace",
    "TraceSchedule",
    "register_trace_dataset",
    "resolve_trace_dataset",
    "trace_dataset_names",
    "clear_trace_cache",
    "reset_trace_stats",
    "trace_cache_info",
    "InfeasibleBudgetError",
    "TunePoint",
    "TuneResult",
    "normalize_optimize",
    "tune_scenario",
    "GraphTileParams",
    "EnGNHardwareParams",
    "HyGCNHardwareParams",
    "TiledSpMMHardwareParams",
    "AWBGCNHardwareParams",
    "RelationalScheduleParams",
    "CompositionHardwareParams",
    "paper_default_graph",
    "PAPER_DEFAULT_GRAPH",
    "PAPER_DEFAULT_ENGN",
    "PAPER_DEFAULT_HYGCN",
    "AcceleratorModel",
    "ModelOutput",
    "MovementTerm",
    "tabulate",
    "L1_CLASSES",
    "L2_CLASSES",
    "CACHE_CLASSES",
]
