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

__all__ = ["ParamArray", "GraphTileParams", "EnGNHardwareParams",
           "HyGCNHardwareParams", "TiledSpMMHardwareParams",
           "AWBGCNHardwareParams", "paper_default_graph"]

ParamArray = Union[int, float, np.ndarray]


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
