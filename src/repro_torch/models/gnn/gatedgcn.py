"""GatedGCN (Bresson & Laurent; config from Dwivedi et al.,
arXiv:2003.00982): its configuration.

The edge-gated model is not ported yet; only :class:`GatedGCNConfig` is,
for the architecture registry.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GatedGCNConfig"]


@dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_in: int = 16
    d_edge_in: int = 16
    d_hidden: int = 70
    n_classes: int = 10
    readout: str = "nodes"        # "nodes" | "graphs"
