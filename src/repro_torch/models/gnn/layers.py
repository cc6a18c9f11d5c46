"""Message-passing primitives over edge lists (the reference's
``models/gnn/layers.py`` in PyTorch).

Message passing is gathers plus ``index_add_`` / ``scatter_reduce_`` over
the edge index, as the reference's is gathers plus ``segment_sum`` /
``segment_max``.  Indices are int64 (:meth:`GraphBatch.to` widens them
once).  The ``aggregate_fn`` hook keeps the reference's signature
``(node_values, senders, receivers, n_nodes, *, edge_weight=None)``.

Every segment sum accumulates in float64 (:func:`repro_torch.models.common.
segment_sum`): in float32 a hub with 2.7e7 in-edges loses about 5% of its
sum, and a count stops at 2^24.  The float64 atomics of ``index_add_`` on
CUDA still add in no fixed order, so results are held at a tolerance.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..common import segment_sum

__all__ = ["AggregateFn", "gather_scatter_sum", "scatter_sum",
           "scatter_mean", "scatter_max"]

AggregateFn = Callable[..., torch.Tensor]


def gather_scatter_sum(node_values: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor, n_nodes: int, *,
                       edge_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """sum_j w_ij * x_j for each receiver i: the SpMM A @ X as a gather and
    a scatter-add."""
    msgs = node_values[senders]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    return segment_sum(msgs, receivers, n_nodes)


def scatter_sum(edge_values: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int, *, edge_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    if edge_mask is not None:
        edge_values = edge_values * edge_mask[..., None]
    return segment_sum(edge_values, receivers, n_nodes)


def scatter_mean(edge_values: torch.Tensor, receivers: torch.Tensor,
                 n_nodes: int, *, edge_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    mask = (edge_mask if edge_mask is not None
            else edge_values.new_ones(edge_values.shape[0]))
    tot = scatter_sum(edge_values, receivers, n_nodes, edge_mask=edge_mask)
    cnt = segment_sum(mask, receivers, n_nodes)
    return tot / torch.clamp_min(cnt, 1.0)[:, None]


def scatter_max(edge_values: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int, *, edge_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Per-receiver maximum.  The output starts at ``-inf`` (so a receiver
    with no edge keeps it) and, as in the reference, every non-finite or
    masked-out (below -1e29) maximum becomes 0."""
    if edge_mask is not None:
        edge_values = torch.where(edge_mask[..., None] > 0, edge_values,
                                  edge_values.new_tensor(-1e30))
    idx = receivers.view(-1, *([1] * (edge_values.dim() - 1))).expand_as(
        edge_values)
    out = edge_values.new_full((n_nodes, *edge_values.shape[1:]),
                               float("-inf"))
    out = out.scatter_reduce(0, idx, edge_values, "amax", include_self=True)
    return torch.where(torch.isfinite(out) & (out > -1e29), out,
                       torch.zeros_like(out))
