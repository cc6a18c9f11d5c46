"""Gemma-2 2B [arXiv:2408.00118]: 26L d2304 8H (GQA kv=4) head 256,
d_ff 9216, vocab 256000, alternating 4k-sliding-window / global attention,
attention softcap 50, final logit softcap 30; 2,614 M parameters, 5.23 GB
in bf16.

The reference's gemma2: its generic pre-norm SwiGLU block with these
widths, window pattern and soft-caps (no GeGLU, post-norms or embedding
scale).  The local layers keep a 4096-slot ring KV cache.  The port serves
it at full width and depth, with K5 on every prefill layer."""

from ..models.transformer import TransformerConfig
from .base import ArchDef, LM_SHAPES

__all__ = ["make_config", "make_smoke_config", "ARCH"]


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
        d_ff=9216, vocab=256000,
        window_pattern=(4096, None),
        attn_softcap=50.0, final_softcap=30.0,
        rope_theta=1e4, **kw)


def make_smoke_config(**kw) -> TransformerConfig:
    """A reduced config of the same family, for the CPU.  Its head dim of 12
    is not one the CUDA kernel K5 takes (multiples of 16)."""
    return TransformerConfig(
        name="gemma2-smoke",
        n_layers=4, d_model=48, n_heads=4, n_kv_heads=2, d_head=12,
        d_ff=96, vocab=256, window_pattern=(8, None),
        attn_softcap=50.0, final_softcap=30.0,
        dtype="float32", q_chunk=16, **kw)


ARCH = ArchDef(
    name="gemma2-2b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    notes="8 heads < tp=16: attention uses context parallelism "
          "(shard_map, q sequence-sharded, kv all-gathered).  Scenario "
          "bridge: the 4k sliding window bounds the banded-graph "
          "neighborhood, so P = K * 4096 (DESIGN.md §5).",
)
