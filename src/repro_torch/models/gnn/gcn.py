"""GCN (Kipf & Welling, arXiv:1609.02907): its configuration.

The model, ``h^{l+1} = act(D^{-1/2} (A + I) D^{-1/2} h^l W^l)``, is not
ported yet; only :class:`GCNConfig` is, for the architecture registry.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GCNConfig"]


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"
    aggregator: str = "mean"      # applied as the sym-norm weighting
    readout: str = "nodes"        # "nodes" | "graphs" (molecule batching)
