"""EquiformerV2 (Liao et al., arXiv:2306.12059): its configuration.

Irrep features pack into ``(l_max + 1)^2`` degree-order rows of ``C``
channels each; the eSCN SO(2) convolution keeps orders ``|m| <= m_max``.
The model is not ported yet; only :class:`EquiformerV2Config` is, with the
irrep bookkeeping the workload bridges read.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EquiformerV2Config"]


@dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128           # channels per irrep degree
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 4                 # scalar input features per node (atom embed)
    d_out: int = 1                # invariant readout (energy)
    # The eSCN convolution processes edges in this many chunks, bounding the
    # (E_chunk, L2, C) message tensor.
    edge_chunks: int = 1

    @property
    def L2(self) -> int:
        return (self.l_max + 1) ** 2

    def m_dim(self, l: int) -> int:
        return min(2 * l + 1, 2 * self.m_max + 1)

    def ls_for_m(self, m: int) -> list[int]:
        return list(range(max(m, 1) if m > 0 else 0, self.l_max + 1))
