"""Training attention and decode attention over a KV cache (the
reference's ``models/attention.py``, single device).

Serving prefill attention is kernel K5 (``kernels.ops.flash_attention``),
which has no backward in either package.  Training attention is
:func:`chunked_causal_attention`, the reference's training path: f32
scores over one chunk of queries at a time, so the materialised block is
``(B, H, q_chunk, S)`` rather than ``(B, H, S, S)``, each chunk
rematerialised in the backward pass.  Decode attention attends one query
per sequence to the cache.  No TPU kernel computes either, so both stay
plain PyTorch, as the reference's are XLA.

A KV cache sequence-sharded over ranks is attended flash-decoding style:
each shard computes a partial softmax over its slots
(:func:`decode_attention_partial`) and the partials combine with a
logsumexp reduction (:func:`combine_decode_partials`): an all-reduce max
and all-reduce sums of ``(B, H, d + 2)`` instead of an all-gather of the
cache.  Context parallelism reaches :func:`chunked_causal_attention` with
``q_offset``, the global position of this rank's first query.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import softcap

__all__ = ["repeat_kv", "chunked_causal_attention", "decode_attention",
           "decode_attention_partial", "combine_decode_partials"]

_NEG_INF = -1e30


def _mask_value(scores_dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.tensor(_NEG_INF, dtype=scores_dtype, device=device)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hk, D) -> (B, S, Hk * n_rep, D) for GQA: head h reads kv head
    h // n_rep."""
    if n_rep == 1:
        return x
    b, s, hk, d = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, n_rep, d).reshape(
        b, s, hk * n_rep, d)


def chunked_causal_attention(
    q: torch.Tensor,                   # (B, Sq, H, D)
    k: torch.Tensor,                   # (B, Skv, Hk, D)
    v: torch.Tensor,                   # (B, Skv, Hk, D)
    *,
    window: Optional[int] = None,      # sliding window; None = global causal
    attn_softcap: Optional[float] = None,
    q_chunk: int = 1024,
    q_offset: int = 0,                 # global position of q row 0 (context parallelism)
    score_budget_bytes: int = 1 << 29,  # cap the fp32 score block (512 MiB)
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over chunks of queries,
    in fp32, returned in ``q``'s dtype.

    The chunk halves from ``q_chunk`` while the fp32 score block
    ``(B*H, q_chunk, S_kv)`` exceeds ``score_budget_bytes`` and the halved
    chunk still divides S; a chunk that does not divide S falls back to one
    block.  Each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``nothing_saveable`` remat): the backward pass recomputes
    its scores instead of keeping every chunk's.  ``q_offset`` places the
    queries at global positions ``q_offset + i`` among the keys (a context
    parallel rank's sequence shard).  The shapes are this rank's own, so the
    budget needs no divisor for sharding (the reference's ``shard_divisor``
    corrects GSPMD's global shapes).

    As in the reference, K and V are repeated over the query heads in
    their own (compute) dtype outside the chunks and cast to fp32 inside
    each.  The chunk's checkpoint takes its tensors as inputs, never by
    closure (not even ``q``, for its device): a non-reentrant checkpoint
    keeps its function, closure and all, until the backward, while its
    inputs are saved through the enclosing saved-tensor hooks.  So under a
    rematerialised decoder group the chunks keep nothing of Q, K and V but
    the positions of the keys, and without one they keep the repeated
    compute-dtype K and V, never an fp32 copy."""
    b, s, h, d = q.shape
    s_kv = k.shape[1]
    n_rep = h // k.shape[2]
    scale = d ** -0.5

    q_chunk = min(q_chunk, s)
    per_row_bytes = b * h * s_kv * 4
    while (q_chunk > 16 and q_chunk * per_row_bytes > score_budget_bytes
           and s % (q_chunk // 2) == 0):
        q_chunk //= 2
    if s % q_chunk:
        q_chunk = s  # irregular sizes take the single-block path
    n_chunks = s // q_chunk

    kt = repeat_kv(k, n_rep).permute(0, 2, 3, 1)  # (B, H, D, Skv)
    vt = repeat_kv(v, n_rep).permute(0, 2, 1, 3)  # (B, H, Skv, D)
    qs = q.permute(0, 2, 1, 3).reshape(b, h, n_chunks, q_chunk, d)
    dev = q.device
    kv_pos = torch.arange(s_kv, device=dev)

    def one_chunk(ci: int, qc: torch.Tensor, kt: torch.Tensor,
                  vt: torch.Tensor) -> torch.Tensor:
        q_pos = (q_offset + ci * q_chunk
                 + torch.arange(q_chunk, device=dev))
        scores = torch.einsum("bhqd,bhdk->bhqk", qc.float() * scale,
                              kt.float())
        if attn_softcap is not None:
            scores = softcap(scores, attn_softcap)
        causal = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            causal &= (q_pos[:, None] - kv_pos[None, :]) < window
        scores = torch.where(causal, scores,
                             _mask_value(scores.dtype, scores.device))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vt.float())

    out = torch.stack([checkpoint(one_chunk, ci, qs[:, :, ci], kt, vt,
                                  use_reentrant=False)
                       for ci in range(n_chunks)], dim=2)
    # (B, H, n_chunks, qc, D) -> (B, S, H, D)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)


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


def decode_attention_partial(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, *,
                             length_mask: torch.Tensor,
                             attn_softcap: Optional[float] = None):
    """Partial-softmax statistics over one sequence shard of the cache.

    Returns (weighted_values (B, 1, H, D), max (B, H, 1), sumexp (B, H, 1)),
    fp32, so that shards combine associatively: the flash-decoding split-K
    scheme."""
    b, _, h, d = q.shape
    n_rep = h // k_shard.shape[2]
    k = repeat_kv(k_shard, n_rep).float()
    v = repeat_kv(v_shard, n_rep).float()
    scores = torch.einsum("bqhd,bshd->bhqs", q.float() * d ** -0.5, k)
    if attn_softcap is not None:
        scores = softcap(scores, attn_softcap)
    scores = scores.masked_fill(~length_mask[:, None, None, :], _NEG_INF)
    m = torch.amax(scores, dim=-1)                      # (B, H, 1)
    e = torch.exp(scores - m[..., None])
    z = torch.sum(e, dim=-1)                            # (B, H, 1)
    wv = torch.einsum("bhqs,bshd->bqhd", e, v)          # un-normalized
    return wv, m, z


def combine_decode_partials(wv: torch.Tensor, m: torch.Tensor,
                            z: torch.Tensor, group) -> torch.Tensor:
    """Combine the flash-decoding partials of the shards of ``group``: an
    all-reduce max of the shards' maxima, then all-reduce sums of the
    rescaled weighted values and sums.  ``group=None`` is one shard (no
    collective)."""
    from ..distributed import comm

    g_max = m if group is None else comm.all_reduce(m, group, "max")
    corr = torch.exp(m - g_max)                         # (B, H, 1)
    wv = wv * corr.transpose(1, 2)[..., None]           # (B, 1, H, D)
    z = z * corr
    if group is not None:
        wv = comm.all_reduce(wv, group)
        z = comm.all_reduce(z, group)
    return wv / z.transpose(1, 2)[..., None]
