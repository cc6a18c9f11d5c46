"""IBM Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: 40L d2048 32H
(GQA kv=8) head 64, d_ff 8192, vocab 49155."""

from ..models.transformer import TransformerConfig
from .base import ArchDef, LM_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="granite-3-2b",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
        d_ff=8192, vocab=49155, rope_theta=1e4, **kw)


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="granite-smoke",
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_head=12,
        d_ff=96, vocab=251,       # deliberately non-divisible like 49155
        dtype="float32", q_chunk=16, **kw)


ARCH = ArchDef(
    name="granite-3-2b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch; 500k decode requires "
                        "sub-quadratic attention (DESIGN.md §5)"},
    notes="vocab 49155 is not divisible by tp=16; the unembed stays "
          "replicated (param_pspecs falls back) — recorded in EXPERIMENTS.md.",
)
