"""AWB-GCN-style column-balanced dataflow as a declarative spec (a copy of the
reference's ``repro/core/awb_gcn.py``).

AWB-GCN (Geng et al., MICRO 2020) computes SpMM by column-wise product on
M PEs with an autotuning workload balancer (efficiency ``eta``) that
reroutes a fraction ``rho`` of partial results.  Vertices and edges stream
once, the column-product accumulation is on-array traffic proportional to
P*T, and the balancer adds an on-array rerouting level.  No movement reads
``graph.L``: AWB-GCN has no high-degree vertex cache.
"""

from __future__ import annotations

import numpy as np

from .dataflow import DataflowSpec, MovementSpec
from .notation import AWBGCNHardwareParams, GraphTileParams
from .terms import ceil, minimum

__all__ = ["AWB_GCN_SPEC"]


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def loadvertcols(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Stream the K x N feature matrix once, column-major."""
    N, _, K, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(K * N * s / B)
    bits = minimum(K * N * s, B) * iters
    return bits, iters


def loadedges(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Stream the P nonzeros (CSC column pointers + row indices)."""
    _, _, _, _, P = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(P * s / B)
    bits = minimum(P * s, B) * iters
    return bits, iters


def loadweights(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Load the N x T combination weights across the PE array."""
    N, T, _, _, _ = g.astuple_f64()
    s, B, M = _f64(hw.sigma), _f64(hw.B), _f64(hw.M)
    iters = ceil(N * T * s / minimum(B, M * s))
    bits = minimum(N * T * s, M * s, B) * iters
    return bits, iters


def columnproduct(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Column-wise-product accumulation: read+write a T-wide partial per edge."""
    _, T, _, _, P = g.astuple_f64()
    s, M, eta = _f64(hw.sigma), _f64(hw.M), _f64(hw.eta)
    bits = 2.0 * P * T * s
    iters = ceil(P * T / (M * eta))
    return bits, iters


def rebalance(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Autotuner rerouting: rho of the partial results cross the task network."""
    _, T, _, _, P = g.astuple_f64()
    s, M, rho = _f64(hw.sigma), _f64(hw.M), _f64(hw.rho)
    bits = rho * P * T * s
    iters = ceil(rho * P / M)
    return bits, iters


def writeout(g: GraphTileParams, hw: AWBGCNHardwareParams):
    """Write the K x T output features back to the memory bank."""
    _, T, K, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(K * T * s / B)
    bits = minimum(K * T * s, B) * iters
    return bits, iters


AWB_GCN_SPEC = DataflowSpec(
    name="awb_gcn",
    movements=(
        MovementSpec("loadvertcols", "L2-L1", loadvertcols, role="vertex_in"),
        MovementSpec("loadedges", "L2-L1", loadedges, role="edges"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
        MovementSpec("columnproduct", "L1-L1", columnproduct, role="compute"),
        MovementSpec("rebalance", "L1-L1", rebalance, role="compute"),
        MovementSpec("writeout", "L1-L2", writeout, role="vertex_out"),
    ),
    hw_factory=AWBGCNHardwareParams,
    description="AWB-GCN column-wise-product SpMM with autotuned workload "
                "balancing (MICRO 2020), in the paper's movement-level style.",
)

