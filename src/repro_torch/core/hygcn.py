"""HyGCN analytical data-movement model: Table IV of the paper (a copy of the
reference's ``repro/core/hygcn.py``).

HyGCN (Yan et al., HPCA 2020) pipelines an aggregation engine of Ma = 32
SIMD cores (each covering up to 8 feature components per step) and a
combination engine, an 8 x 4 x 128 systolic array with weight reuse factor
Gamma.  Aggregated features cross an inter-phase buffer, which is why
HyGCN's off-chip movement exceeds EnGN's at matched parameters.  Each closed
form is one row of Table IV, assembled into :data:`HYGCN_SPEC`.  P_s (edges
surviving window sliding) is ``Ps_ratio * P``, with the paper's P_s ~ P.
"""

from __future__ import annotations

import numpy as np

from .dataflow import DataflowSpec, MovementSpec
from .notation import GraphTileParams, HyGCNHardwareParams
from .terms import ceil, minimum

__all__ = ["HYGCN_SPEC"]


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def loadvertL2(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 1: stream all K vertices of the tile into the aggregation engine."""
    N, _, K, _, _ = g.astuple_f64()
    s, B, Ma = _f64(hw.sigma), _f64(hw.B), _f64(hw.Ma)
    iters = ceil(K * s / minimum(B, Ma * s))
    bits = minimum(K * s, Ma * s, B) * N * iters
    return bits, iters


def loadedges(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 2: stream the P_s window-slid edges."""
    _, _, _, _, P = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    Ps = hw.Ps(P)
    iters = ceil(Ps * s / B)
    bits = minimum(Ps * s, B) * iters
    return bits, iters


def loadweights(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 3: load the (1 - Gamma) non-reused fraction of the N x T weights."""
    N, T, _, _, _ = g.astuple_f64()
    s, B, Mc = _f64(hw.sigma), _f64(hw.B), _f64(hw.Mc)
    gamma = _f64(hw.gamma)
    fresh = N * T * s * (1.0 - gamma)
    iters = ceil(fresh / minimum(B, Mc * s))
    bits = minimum(fresh, Mc * s, B) * iters
    return bits, iters


def aggregate(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 4: SIMD aggregation, every core handling <= 8 feature components.

    Table IV verbatim: it caps N*Ps*sigma (bits) against Ma (a PE count)
    scaled by 8.0, and ceils the bits ratio directly.
    """
    N, _, _, _, P = g.astuple_f64()
    s, Ma = _f64(hw.sigma), _f64(hw.Ma)
    Ps = hw.Ps(P)
    iters = ceil(N * Ps * s / (Ma * 8.0))
    bits = minimum(N * Ps * s, Ma * 8.0) * iters
    return bits, iters


def writeinterphase(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 5: spill aggregated K x N features to the inter-phase buffer."""
    N, _, K, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(K * N * s / B)
    bits = minimum(K * N * s, B) * iters
    return bits, iters


def combine(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 6: systolic matrix-vector combination (single on-array pass)."""
    N, T, K, _, _ = g.astuple_f64()
    s = _f64(hw.sigma)
    bits = K * N * s + N * T * s
    return bits, np.ones_like(bits)


def readinterphase(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 7: the combination engine fetches aggregated features back.

    Table IV verbatim: min(B, Mc) compares a bits-per-iteration bandwidth
    against a systolic-array PE count.
    """
    N, _, _, _, P = g.astuple_f64()
    s, B, Mc = _f64(hw.sigma), _f64(hw.B), _f64(hw.Mc)
    Ps = hw.Ps(P)
    iters = ceil(Ps * N * s / minimum(B, Mc))
    bits = minimum(Ps * N * s, B, Mc) * iters
    return bits, iters


def writeL2(g: GraphTileParams, hw: HyGCNHardwareParams):
    """Row 8: write the K x T output features to the output buffer."""
    _, T, K, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(K * T * s / B)
    bits = minimum(K * T * s, B) * iters
    return bits, iters


#: Table IV, declaratively: the rows in published order.
HYGCN_SPEC = DataflowSpec(
    name="hygcn",
    movements=(
        MovementSpec("loadvertL2", "L2-L1", loadvertL2, role="vertex_in"),
        MovementSpec("loadedges", "L2-L1", loadedges, role="edges"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
        MovementSpec("aggregate", "L1-L1", aggregate, role="compute"),
        MovementSpec("writeinterphase", "L1-L2", writeinterphase,
                     role="interphase"),
        MovementSpec("combine", "L1-L1", combine, role="compute"),
        MovementSpec("readinterphase", "L2-L1", readinterphase,
                     role="interphase"),
        MovementSpec("writeL2", "L1-L2", writeL2, role="vertex_out"),
    ),
    hw_factory=HyGCNHardwareParams,
    description="HyGCN dual-engine (SIMD aggregation + systolic combination) "
                "dataflow with an inter-phase buffer (Table IV).",
)

