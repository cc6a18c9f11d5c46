"""EnGN analytical data-movement model: Table III of the paper (a copy of the
reference's ``repro/core/engn.py``).

EnGN (Liang et al., IEEE TC 2020) processes aggregation and combination
sequentially on a single M x M' PE array, with a ring-edge-reduce (RER)
dataflow for aggregation and a dedicated cache (L2*) for high-degree
vertices.  Each closed form below is one row of Table III, assembled into
:data:`ENGN_SPEC`.

* ``aggregate`` clamps the numerator of ``ceil(K (N - M) / M)`` at 0 (for
  M >= N the second streaming pass never happens), the reading that
  reproduces Fig. 3's non-monotone behaviour in M.
* The paper's prose ``intertile`` step has no row in Table III and is not
  charged, so totals match the published table.
"""

from __future__ import annotations

import numpy as np

from .dataflow import DataflowSpec, MovementSpec, SpecModel
from .notation import EnGNHardwareParams, GraphTileParams
from .terms import ceil, minimum

__all__ = ["EnGNModel", "ENGN_SPEC"]


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def loadvertcache(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 1: stream the L high-degree vertices from the dedicated cache."""
    N, _, _, L, _ = g.astuple_f64()
    s, Bs, M = _f64(hw.sigma), hw.b_star, _f64(hw.M)
    iters = ceil(L * s / minimum(Bs, M * s))
    bits = minimum(L * s, M * s, Bs) * N * iters
    return bits, iters


def loadvertL2(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 2: stream the remaining K - L vertices from the L2 bank."""
    N, _, K, L, _ = g.astuple_f64()
    s, B, M = _f64(hw.sigma), _f64(hw.B), _f64(hw.M)
    rem = np.maximum(K - L, 0.0)
    iters = ceil(rem * s / minimum(B, M * s))
    bits = minimum(rem * s, M * s, B) * N * iters
    return bits, iters


def loadedges(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 3: stream the tile's P edges."""
    _, _, _, _, P = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(P * s / B)
    bits = minimum(P * s, B) * iters
    return bits, iters


def loadweights(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 4: load the N x T combination weights, streamed by output column."""
    N, T, _, _, _ = g.astuple_f64()
    s, B, M = _f64(hw.sigma), _f64(hw.B), _f64(hw.M)
    iters = ceil(T * s / minimum(B, M * s))
    bits = minimum(T * s, M * s, B) * N * iters
    return bits, iters


def aggregate(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 5: ring-edge-reduce aggregation across the PE array (L1-L1).

    Each of the ceil(K/M) vertex groups circulates partial sums around the
    M-PE ring (M-1 hops of T outputs each); features beyond the first M
    elements require extra streaming passes, ceil(K (N - M)+ / M).
    """
    N, T, K, _, _ = g.astuple_f64()
    s, M = _f64(hw.sigma), _f64(hw.M)
    passes = ceil(K / M) + ceil(K * np.maximum(N - M, 0.0) / M)
    bits = M * (M - 1.0) * T * passes * s
    return bits, passes


def writecache(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 6: write high-degree vertex results back to the dedicated cache."""
    _, T, _, L, _ = g.astuple_f64()
    s, Bs, M = _f64(hw.sigma), hw.b_star, _f64(hw.M)
    iters = ceil(L * s / minimum(M * s, Bs))
    bits = minimum(M * s, L * s, Bs) * T * iters
    return bits, iters


def writeL2(g: GraphTileParams, hw: EnGNHardwareParams):
    """Row 7: write the remaining results to the L2 bank."""
    _, T, K, L, _ = g.astuple_f64()
    s, B, M = _f64(hw.sigma), _f64(hw.B), _f64(hw.M)
    rem = np.maximum(K - L, 0.0)
    iters = ceil(rem * s / minimum(M * s, B))
    bits = minimum(M * s, rem * s, B) * T * iters
    return bits, iters


#: Table III, declaratively: the rows in published order.
ENGN_SPEC = DataflowSpec(
    name="engn",
    movements=(
        MovementSpec("loadvertcache", "L2*-L1", loadvertcache, role="vertex_in"),
        MovementSpec("loadvertL2", "L2-L1", loadvertL2, role="vertex_in"),
        MovementSpec("loadedges", "L2-L1", loadedges, role="edges"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
        MovementSpec("aggregate", "L1-L1", aggregate, role="compute"),
        MovementSpec("writecache", "L1-L2*", writecache, role="vertex_out"),
        MovementSpec("writeL2", "L1-L2", writeL2, role="vertex_out"),
    ),
    hw_factory=EnGNHardwareParams,
    description="EnGN single-array RER dataflow with a high-degree vertex "
                "cache (Table III).",
    # M_prime (PE-array columns) enters only fitting_factor (Fig. 6), not
    # any Table III movement form: a recorded audit waiver.
    unused_hw=("M_prime",),
)


class EnGNModel(SpecModel):
    """Table III assembled: the EnGN per-tile data-movement model."""

    spec = ENGN_SPEC

    def fitting_factor(self, graph: GraphTileParams,
                       hw: EnGNHardwareParams) -> np.ndarray:
        """EnGN array-fitting factor K*N / M^2 studied in Fig. 6 (M = M')."""
        N, _, K, _, _ = graph.astuple_f64()
        return K * N / (_f64(hw.M) * _f64(hw.M_prime))
