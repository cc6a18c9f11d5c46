"""Decode attention over a KV cache (the reference's
``models/attention.py``, single device).

Prefill attention is kernel K5 (``kernels.ops.flash_attention``).  Decode
attention attends one query per sequence to the cache; no TPU kernel
computes it, so it stays plain PyTorch.  The reference's sequence-sharded
partials (``decode_attention_partial``, ``combine_decode_partials``) wait
for the distributed port.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import softcap

__all__ = ["repeat_kv", "decode_attention"]

_NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hk, D) -> (B, S, Hk * n_rep, D) for GQA: head h reads kv head
    h // n_rep."""
    if n_rep == 1:
        return x
    b, s, hk, d = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, n_rep, d).reshape(
        b, s, hk * n_rep, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, length_mask: torch.Tensor,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention: q (B, 1, H, D) over caches (B, S, Hk, D);
    ``length_mask`` (B, S) is True where a cache slot is valid.  fp32."""
    b, _, h, d = q.shape
    n_rep = h // k_cache.shape[2]
    k = repeat_kv(k_cache, n_rep).float()
    v = repeat_kv(v_cache, n_rep).float()
    scores = torch.einsum("bqhd,bshd->bhqs", q.float() * d ** -0.5, k)
    if attn_softcap is not None:
        scores = softcap(scores, attn_softcap)
    scores = scores.masked_fill(~length_mask[:, None, None, :], _NEG_INF)
    out = torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.to(q.dtype)
