"""GCN on Cora [arXiv:1609.02907]: 2 layers, d_hidden 16, symmetric norm."""

from ..models.gnn.gcn import GCNConfig
from .base import ArchDef, GNN_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(*, d_in: int = 1433, n_classes: int = 7, **kw) -> GCNConfig:
    return GCNConfig(name="gcn-cora", n_layers=2, d_in=d_in, d_hidden=16,
                     n_classes=n_classes, norm="sym", **kw)


def make_smoke_config(**kw) -> GCNConfig:
    return GCNConfig(name="gcn-smoke", n_layers=2, d_in=24, d_hidden=8,
                     n_classes=3, **kw)


ARCH = ArchDef(name="gcn-cora", family="gnn",
               make_config=make_config, make_smoke_config=make_smoke_config,
               shapes=GNN_SHAPES)
