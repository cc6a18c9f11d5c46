"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: 30L d576 9H (GQA kv=3)
head 64, d_ff 1536, vocab 49152, tied embeddings (llama-arch small);
134.5 M parameters.  The serving path of the port runs it at full width and
depth."""

from ..models.transformer import TransformerConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="smollm-135m",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
        d_ff=1536, vocab=49152, rope_theta=1e4, **kw)


def make_smoke_config(**kw) -> TransformerConfig:
    """A reduced config of the same family, for the CPU.  Its head dim of 12
    is not one the CUDA kernel K5 takes (multiples of 16)."""
    return TransformerConfig(
        name="smollm-smoke",
        n_layers=3, d_model=36, n_heads=3, n_kv_heads=3, d_head=12,
        d_ff=96, vocab=256, dtype="float32", **kw)
