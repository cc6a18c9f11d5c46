"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d2048 32H (GQA kv=4) head 128,
MoE 128 experts top-8, expert d_ff 768, vocab 151936.

30.2 B parameters, 60.44 GB in bf16: the model fits one 80 GB card whole."""

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .base import ArchDef, LM_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=768, vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                      capacity_factor=1.25),
        rope_theta=1e6, **kw)


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0),
        dtype="float32", q_chunk=16, **kw)


ARCH = ArchDef(
    name="qwen3-moe-30b-a3b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch; 500k decode requires "
                        "sub-quadratic attention (DESIGN.md §5)"},
)
