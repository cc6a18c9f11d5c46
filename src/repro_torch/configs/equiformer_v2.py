"""EquiformerV2 [arXiv:2306.12059]: 12 layers, 128 channels, l_max 6,
m_max 2, 8 heads, SO(2)-eSCN convolutions."""

from ..models.gnn.equiformer_v2 import EquiformerV2Config
from .base import ArchDef, GNN_SHAPES

__all__ = ["make_config", "make_smoke_config", "scenario_widths", "ARCH"]


def make_config(*, d_in: int = 16, **kw) -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-v2", n_layers=12,
                              d_hidden=128, l_max=6, m_max=2, n_heads=8,
                              d_in=d_in, **kw)


def make_smoke_config(**kw) -> EquiformerV2Config:
    return EquiformerV2Config(name="equiformer-smoke", n_layers=2,
                              d_hidden=16, l_max=2, m_max=1, n_heads=4,
                              d_in=8, **kw)


def scenario_widths(cfg, params) -> list[int]:
    """The tile language: irreps flatten to N_eff = (l_max+1)^2 * C per
    layer."""
    n_eff = (cfg.l_max + 1) ** 2 * cfg.d_hidden
    return [params.get("d_feat", cfg.d_in)] + [n_eff] * cfg.n_layers


ARCH = ArchDef(name="equiformer-v2", family="gnn",
               make_config=make_config, make_smoke_config=make_smoke_config,
               shapes=GNN_SHAPES,
               notes="Irrep features flatten to N_eff = (l_max+1)^2 * C for "
                     "the paper's tile models (DESIGN.md §5). Self-loop-free "
                     "edge lists required (zero edge vectors have no frame).",
               scenario_widths=scenario_widths)
