"""GatedGCN [arXiv:2003.00982 benchmarking config]: 16 layers, d_hidden 70,
gated edge aggregation."""

from ..models.gnn.gatedgcn import GatedGCNConfig
from .base import ArchDef, GNN_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(*, d_in: int = 16, n_classes: int = 10,
                **kw) -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn", n_layers=16, d_in=d_in,
                          d_edge_in=16, d_hidden=70, n_classes=n_classes,
                          **kw)


def make_smoke_config(**kw) -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn-smoke", n_layers=3, d_in=8,
                          d_edge_in=4, d_hidden=12, n_classes=3, **kw)


ARCH = ArchDef(name="gatedgcn", family="gnn",
               make_config=make_config, make_smoke_config=make_smoke_config,
               shapes=GNN_SHAPES)
