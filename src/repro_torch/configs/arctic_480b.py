"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: 35L d7168 56H
(GQA kv=8) head 128, MoE 128 experts top-2 (expert d_ff 4864) + dense
residual MLP, vocab 32000.

476.6 B parameters, 27.22 GB a layer in bf16: one 80 GB card holds two of
its 35 layers."""

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .base import ArchDef, LM_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=4864, vocab=32000,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      capacity_factor=1.25, dense_residual_d_ff=4864),
        rope_theta=1e6, **kw)


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="arctic-smoke",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=48, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                      capacity_factor=2.0, dense_residual_d_ff=48),
        dtype="float32", q_chunk=16, **kw)


ARCH = ArchDef(
    name="arctic-480b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch; 500k decode requires "
                        "sub-quadratic attention (DESIGN.md §5)"},
)
