"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): its configuration.

The encode-process-decode model is not ported yet; only
:class:`MeshGraphNetConfig` is, for the architecture registry.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MeshGraphNetConfig"]


@dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15            # processor message-passing steps
    d_in: int = 12                # node input features (velocity, type, ...)
    d_edge_in: int = 4            # relative displacement + norm
    d_hidden: int = 128
    mlp_layers: int = 2
    d_out: int = 3                # predicted acceleration / field delta
