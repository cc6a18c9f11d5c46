"""MeshGraphNet [arXiv:2010.03409]: 15 processor layers, d_hidden 128,
sum aggregation, 2-layer MLPs."""

from ..models.gnn.meshgraphnet import MeshGraphNetConfig
from .base import ArchDef, GNN_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(*, d_in: int = 12, **kw) -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet", n_layers=15, d_in=d_in,
                              d_hidden=128, mlp_layers=2, **kw)


def make_smoke_config(**kw) -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet-smoke", n_layers=3, d_in=8,
                              d_hidden=16, mlp_layers=2, **kw)


ARCH = ArchDef(name="meshgraphnet", family="gnn",
               make_config=make_config, make_smoke_config=make_smoke_config,
               shapes=GNN_SHAPES)
