"""Plain-PyTorch oracles of the GNN layer (the tolerance targets)."""

from __future__ import annotations

import torch

from ..backend import full_fp32

__all__ = ["fused_aggregate_combine_ref", "edge_list_aggregate_ref"]


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
