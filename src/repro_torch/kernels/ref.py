"""Plain-PyTorch oracles of the kernels (the tolerance targets)."""

from __future__ import annotations

from typing import Optional

import torch

from ..backend import full_fp32

__all__ = ["fused_aggregate_combine_ref", "edge_list_aggregate_ref",
           "flash_attention_ref", "embedding_bag_ref"]


def fused_aggregate_combine_ref(adjacency: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """Y = (A @ X) @ W in fp32 accumulation, cast to ``x.dtype``."""
    full_fp32()
    agg = adjacency.float() @ x.float()
    return (agg @ w.float()).to(x.dtype)


def edge_list_aggregate_ref(x: torch.Tensor, senders: torch.Tensor,
                            receivers: torch.Tensor, weights: torch.Tensor,
                            n_nodes: int) -> torch.Tensor:
    """Edge-list semantics the block-dense adjacency must reproduce."""
    msgs = x[senders] * weights[:, None]
    out = torch.zeros((n_nodes, x.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, receivers, msgs)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """(B, S, H, D) attention oracle in fp32, k and v with the same heads:
    scaled after the dot, softcapped, masked to -1e30, softmax."""
    full_fp32()
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = scores.masked_fill(~mask, -1e30)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.to(q.dtype)


def embedding_bag_ref(table: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (B, hot) ids -> (B, D) summed bags: take, then sum
    (in bf16 this rounds otherwise than the kernels' sequential sum)."""
    return table[indices.long()].sum(dim=1)
