"""Table II notation of the paper, as typed parameter records (a copy of the
reference's graph-tile and hardware records and ``paper_default_graph``).

Feature sizes ``N`` (input) and ``T`` (output) are element counts, ``sigma``
is the bit precision of one element and ``B`` the L2 bandwidth in bits per
iteration.  Fields are scalars or numpy arrays; the closed forms broadcast,
in exact integer-valued float64.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Union

import numpy as np

__all__ = ["ParamArray", "GraphTileParams", "RelationalScheduleParams",
           "CompositionHardwareParams", "EnGNHardwareParams",
           "HyGCNHardwareParams", "TiledSpMMHardwareParams",
           "AWBGCNHardwareParams", "paper_default_graph",
           "PAPER_DEFAULT_GRAPH", "PAPER_DEFAULT_ENGN", "PAPER_DEFAULT_HYGCN",
           "FieldUnit", "UNIT_DECLARATIONS", "declare_units",
           "unit_declarations_for"]

ParamArray = Union[int, float, np.ndarray]


# ---------------------------------------------------------------------------
# Unit declarations (read by :mod:`repro_torch.analysis`).
#
# Every Table II symbol is declared with a unit tag and the operating
# envelope the static auditor propagates interval bounds over.  ``bits``
# and ``bits/iter`` both reduce to the ``bits`` dimension (B is the
# payload one iteration can move), while counts (``elements`` /
# ``vertices`` / ``edges`` / ``PEs``) are dimensionless multipliers, so
# every Table III/IV data-movement form must reduce to bits^1 and every
# iteration form to bits^0.  A dropped ``sigma`` factor breaks that
# reduction, which is what the auditor fails on.
#
# Graph symbols carry the operating envelope of 10^9 edges / 10^7
# vertices; hardware symbols default to ``lo=hi=None``, meaning the
# auditor pins them to the spec's own ``hw_factory()`` defaults (a point
# interval at the published design point).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FieldUnit:
    """Unit + envelope declaration of one parameter-record field.

    ``unit`` is one of the Table II tags: ``"bits"``, ``"bits/iter"``,
    ``"elements"``, ``"vertices"``, ``"edges"``, ``"PEs"``,
    ``"relations"``, ``"dimensionless"``.  ``lo``/``hi`` bound the field
    over the audited operating envelope; ``None`` means "pin to the
    record's default value".
    """

    unit: str
    lo: float | None = None
    hi: float | None = None
    doc: str = ""


#: record type -> {field name -> FieldUnit}.  Extend via :func:`declare_units`.
UNIT_DECLARATIONS: dict[type, dict[str, FieldUnit]] = {}


def declare_units(record_type: type, fields: dict[str, FieldUnit],
                  *, overwrite: bool = False) -> None:
    """Register unit declarations for a parameter-record dataclass.

    Dataflow specs whose hardware records are not declared here must call
    this before :func:`repro_torch.analysis.audit_spec` can trace them.
    """
    if record_type in UNIT_DECLARATIONS and not overwrite:
        raise ValueError(f"unit declarations for {record_type.__name__} "
                         "already registered (pass overwrite=True)")
    declared = set(fields)
    actual = {f.name for f in dataclasses.fields(record_type)}
    if declared != actual:
        raise ValueError(
            f"unit declarations for {record_type.__name__} must cover every "
            f"field exactly once; missing={sorted(actual - declared)} "
            f"extra={sorted(declared - actual)}")
    UNIT_DECLARATIONS[record_type] = dict(fields)


def unit_declarations_for(record) -> dict[str, FieldUnit]:
    """Resolve the declaration table for a record instance (exact type)."""
    try:
        return UNIT_DECLARATIONS[type(record)]
    except KeyError:
        raise KeyError(
            f"no unit declarations for parameter record type "
            f"{type(record).__name__}; call repro_torch.core.notation."
            f"declare_units({type(record).__name__}, {{...}}) so the "
            f"analysis auditor can trace specs using it") from None


def _f64(x: ParamArray) -> np.ndarray:
    """Promote a parameter to float64 (exact for all integer magnitudes used)."""
    return np.asarray(x, dtype=np.float64)


@dataclass(frozen=True)
class GraphTileParams:
    """Input-graph parameters of a single tile (Table II, left column).

    Attributes:
      N: size of the input feature vector (elements).
      T: size of the output feature vector (elements).
      K: number of vertices in the tile.
      L: number of high-degree vertices in the tile.
      P: number of edges in the tile.
    """

    N: ParamArray
    T: ParamArray
    K: ParamArray
    L: ParamArray
    P: ParamArray

    def replace(self, **kw: ParamArray) -> "GraphTileParams":
        return dataclasses.replace(self, **kw)

    def astuple_f64(self) -> tuple[np.ndarray, ...]:
        return tuple(_f64(v) for v in (self.N, self.T, self.K, self.L, self.P))


@dataclass(frozen=True)
class EnGNHardwareParams:
    """EnGN architecture parameters (Table II, right column).

    Attributes:
      sigma: bit precision of a feature element.
      B: L2 memory-bank bandwidth, bits/iteration.
      B_star: dedicated high-degree vertex-cache (L2*) bandwidth,
        bits/iteration.  Not given a default in the paper; defaults to ``B``.
      M: PE-array rows (vertices processed concurrently).
      M_prime: PE-array columns. EnGN default array is 128 x 16.
    """

    sigma: ParamArray = 4
    B: ParamArray = 1000
    B_star: ParamArray | None = None
    M: ParamArray = 128
    M_prime: ParamArray = 16

    @property
    def b_star(self) -> np.ndarray:
        return _f64(self.B if self.B_star is None else self.B_star)

    def replace(self, **kw: ParamArray) -> "EnGNHardwareParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HyGCNHardwareParams:
    """HyGCN architecture parameters (Table II, right column).

    Attributes:
      sigma: bit precision.
      B: L2 memory bandwidth, bits/iteration.
      Ma: aggregation-engine PEs (32 SIMD cores, each covering up to 8
          feature components per step, the ``Ma * 8`` term in Table IV).
      Mc: combination-engine PEs (systolic array, 8 x 4 x 128 = 4096).
      gamma: systolic-array weight-reuse factor, 0 <= gamma < 1.
      Ps_ratio: edges remaining after HyGCN's window sliding, as a fraction
          of P.  The paper sets P_s ~ P, i.e. ratio 1.0.
    """

    sigma: ParamArray = 4
    B: ParamArray = 1000
    Ma: ParamArray = 32
    Mc: ParamArray = 8 * 4 * 128
    gamma: ParamArray = 0.5
    Ps_ratio: ParamArray = 1.0

    def Ps(self, P: ParamArray) -> np.ndarray:
        return _f64(P) * _f64(self.Ps_ratio)

    def replace(self, **kw: ParamArray) -> "HyGCNHardwareParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TiledSpMMHardwareParams:
    """Tiled block-dense SpMM accelerator.

    Attributes:
      sigma: bit precision of a feature element.
      B: L2 bandwidth, bits/iteration.
      Bn: destination-vertex rows per adjacency block.
      Bk: source-vertex columns per adjacency block.
      sigma_adj: bit precision of one adjacency-block element (block-dense
          storage keeps explicit zeros, so topology traffic is dense).
    """

    sigma: ParamArray = 4
    B: ParamArray = 1000
    Bn: ParamArray = 256
    Bk: ParamArray = 256
    sigma_adj: ParamArray = 4

    def replace(self, **kw: ParamArray) -> "TiledSpMMHardwareParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AWBGCNHardwareParams:
    """AWB-GCN-style column-balanced dataflow (the reference's extension).

    Attributes:
      sigma: bit precision.
      B: L2 memory bandwidth, bits/iteration.
      M: number of PEs (AWB-GCN's published design point is 4096).
      eta: workload-balance efficiency achieved by the autotuner,
          0 < eta <= 1 (fraction of peak PE utilization).
      rho: fraction of partial results rerouted by the balancer.
    """

    sigma: ParamArray = 4
    B: ParamArray = 1000
    M: ParamArray = 4096
    eta: ParamArray = 0.85
    rho: ParamArray = 0.1

    def replace(self, **kw: ParamArray) -> "AWBGCNHardwareParams":
        return dataclasses.replace(self, **kw)


def paper_default_graph(
    K: ParamArray = 1024,
    *,
    N: ParamArray = 30,
    T: ParamArray = 5,
    edge_factor: float = 10.0,
    high_degree_fraction: float = 0.1,
) -> GraphTileParams:
    """Paper defaults (Sec. IV): N=30, T=5, P = 10 * K.

    ``L`` (high-degree vertices) has no published default; the
    degree-aware cache serves 10% of the tile's vertices.
    """
    K_arr = _f64(K)
    return GraphTileParams(
        N=_f64(N),
        T=_f64(T),
        K=K_arr,
        L=np.floor(K_arr * high_degree_fraction),
        P=K_arr * edge_factor,
    )


#: Section IV default operating point: N=30, T=5, B=1000, sigma=4, P=10K.
PAPER_DEFAULT_GRAPH = paper_default_graph()
PAPER_DEFAULT_ENGN = EnGNHardwareParams()
PAPER_DEFAULT_HYGCN = HyGCNHardwareParams()


# Table II, left column: the graph tile, over the operating envelope of
# 10^9-edge / 10^7-vertex graphs with feature widths up to 1024 elements.
declare_units(GraphTileParams, {
    "N": FieldUnit("elements", 1, 1024, "input feature-vector size"),
    "T": FieldUnit("elements", 1, 1024, "output feature-vector size"),
    "K": FieldUnit("vertices", 1, 1e7, "vertices in the tile"),
    "L": FieldUnit("vertices", 0, 1e7, "high-degree vertices in the tile"),
    "P": FieldUnit("edges", 0, 1e9, "edges in the tile"),
})

# Table II, right column (EnGN).
declare_units(EnGNHardwareParams, {
    "sigma": FieldUnit("bits", doc="precision of one feature element"),
    "B": FieldUnit("bits/iter", doc="L2 bank bandwidth"),
    "B_star": FieldUnit("bits/iter", doc="dedicated L2* cache bandwidth"),
    "M": FieldUnit("PEs", doc="PE-array rows"),
    "M_prime": FieldUnit("PEs", doc="PE-array columns"),
})

# Table II, right column (HyGCN).
declare_units(HyGCNHardwareParams, {
    "sigma": FieldUnit("bits", doc="precision of one feature element"),
    "B": FieldUnit("bits/iter", doc="L2 memory bandwidth"),
    "Ma": FieldUnit("PEs", doc="aggregation-engine SIMD cores"),
    "Mc": FieldUnit("PEs", doc="combination-engine systolic PEs"),
    "gamma": FieldUnit("dimensionless", doc="systolic weight-reuse factor"),
    "Ps_ratio": FieldUnit("dimensionless",
                          doc="edges surviving window sliding, / P"),
})

# The reference's extensions: the block-dense SpMM and AWB-GCN.
declare_units(TiledSpMMHardwareParams, {
    "sigma": FieldUnit("bits", doc="precision of one feature element"),
    "B": FieldUnit("bits/iter", doc="HBM bandwidth"),
    "Bn": FieldUnit("vertices", doc="destination rows per adjacency block"),
    "Bk": FieldUnit("vertices", doc="source columns per adjacency block"),
    "sigma_adj": FieldUnit("bits", doc="precision of one adjacency element"),
})

declare_units(AWBGCNHardwareParams, {
    "sigma": FieldUnit("bits", doc="precision of one feature element"),
    "B": FieldUnit("bits/iter", doc="L2 memory bandwidth"),
    "M": FieldUnit("PEs", doc="column-product PEs"),
    "eta": FieldUnit("dimensionless", doc="autotuned balance efficiency"),
    "rho": FieldUnit("dimensionless", doc="rerouted partial-result fraction"),
})


# ---------------------------------------------------------------------------
# Composition-layer parameter records: the typed-graph / minibatch closed
# forms of repro_torch.core.compose.COMPOSITION_FORMS are traced over
# these, so the relation axis is audited with the same unit algebra,
# provenance tracking and 2^53 interval envelope as the Table III/IV terms.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RelationalScheduleParams:
    """Per-tile schedule quantities of the typed / episode evaluations.

    Attributes:
      R: number of edge relations (types) in the typed graph; 1 for a
         homogeneous sampled-minibatch episode.
      H: unique remote (halo / gathered non-seed) source vertices of one
         tile or episode, the exact deduplicated count the trace measures.
      K: vertices resident in the tile (partition geometry, shared across
         relations).
      W: per-vertex feature elements moved per halo/hand-off vertex (the
         summed interior widths, ``halo_feature_elems``).
    """

    R: ParamArray
    H: ParamArray
    K: ParamArray
    W: ParamArray

    def replace(self, **kw: ParamArray) -> "RelationalScheduleParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CompositionHardwareParams:
    """Architecture-independent hardware knobs of the composition terms.

    Every registered dataflow shares these two Table II symbols; the
    composition layer charges its halo / hand-off / gather terms with them
    regardless of which inner dataflow runs the tile.
    """

    sigma: ParamArray = 4
    B: ParamArray = 1000

    def replace(self, **kw: ParamArray) -> "CompositionHardwareParams":
        return dataclasses.replace(self, **kw)


# Relation counts span 1-64; halo / vertex counts share the vertex envelope
# (a tile's unique remote sources are at most V); widths share the
# feature-element envelope.
declare_units(RelationalScheduleParams, {
    "R": FieldUnit("relations", 1, 64, "edge relations in the typed graph"),
    "H": FieldUnit("vertices", 0, 1e7,
                   "unique remote / gathered source vertices per tile"),
    "K": FieldUnit("vertices", 1, 1e7, "vertices resident in the tile"),
    "W": FieldUnit("elements", 1, 1024,
                   "halo feature elements moved per vertex"),
})

declare_units(CompositionHardwareParams, {
    "sigma": FieldUnit("bits", doc="precision of one feature element"),
    "B": FieldUnit("bits/iter", doc="L2 memory bandwidth"),
})
