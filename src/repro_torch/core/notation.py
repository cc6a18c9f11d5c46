"""Table II notation of the paper, as typed parameter records (a copy of the
reference's ``GraphTileParams`` and ``TiledSpMMHardwareParams``).

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

__all__ = ["GraphTileParams", "TiledSpMMHardwareParams"]

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
