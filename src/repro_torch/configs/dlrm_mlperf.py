"""DLRM MLPerf [arXiv:1906.00091]: 13 dense + 26 sparse features
(Criteo-1TB vocabularies), embed dim 128, bottom MLP 512-256-128, top MLP
1024-1024-512-256-1, dot interaction.  The published tables hold
204,184,588 rows (104.5 GB in f32); ``make_config(vocab_sizes=...)`` takes
a cut, as the reference's does."""

from ..models.dlrm import CRITEO_1TB_VOCABS, DLRMConfig
from .base import ArchDef, RECSYS_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(**kw) -> DLRMConfig:
    return DLRMConfig(name="dlrm-mlperf", **kw)


def make_smoke_config(**kw) -> DLRMConfig:
    """A reduced config of the same family, for the CPU: tables capped at
    128 rows, embed dim 16."""
    return DLRMConfig(
        name="dlrm-smoke", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_sizes=tuple(min(v, 128) for v in CRITEO_1TB_VOCABS),
        bot_mlp=(32, 16), top_mlp=(64, 32, 1), **kw)


ARCH = ArchDef(name="dlrm-mlperf", family="recsys",
               make_config=make_config, make_smoke_config=make_smoke_config,
               shapes=RECSYS_SHAPES,
               notes="Tables row-sharded over the model axis (vocab-parallel "
                     "lookup + psum baseline; all-to-all is the §Perf "
                     "optimization).  Scenario bridge (§5): a batch is a "
                     "tile of K = batch example-vertices each gathering "
                     "n_sparse embedding rows (P = 26K edges, N = 128); "
                     "combination is the dot interaction + top MLP (T = 1).")
