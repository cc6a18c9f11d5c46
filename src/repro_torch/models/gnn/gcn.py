"""GCN (Kipf & Welling, arXiv:1609.02907), the paper's canonical workload
(the reference's ``models/gnn/gcn.py`` in PyTorch).

h^{l+1} = act( D^{-1/2} (A + I) D^{-1/2} h^l W^l ), with the transform
applied *before* aggregation (X W then A ·) so the aggregated feature width
is d_hidden, not d_in: the order EnGN streams tiles in.  Aggregation is
plain PyTorch (:func:`.layers.gather_scatter_sum`) unless the caller hands
an ``aggregate_fn`` with its signature.

On a :class:`.graph.GraphShard` (nodes and edges over every mesh axis) the
transform runs on the rank's rows, the all-gather of ``h`` (widths
``d_hidden``, then ``n_classes``) feeds the senders, and the weighted sum
over a receiver's edges is local; the coefficients come from the global
batch's degrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ...backend import resolve_device
from .graph import GraphBatch, sym_norm_coeffs
from ..common import segment_sum
from .layers import gather_scatter_sum

__all__ = ["GCNConfig", "GCN", "layer_dims", "loss_fn"]


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"
    aggregator: str = "mean"      # applied as the sym-norm weighting
    readout: str = "nodes"        # "nodes" | "graphs" (molecule batching)


def layer_dims(cfg: GCNConfig) -> list[int]:
    """[d_in, d_hidden, ..., n_classes]: the widths the layers chain."""
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


class GCN(nn.Module):
    """The f32 weights ``w[l]`` (d_l, d_{l+1}) and ``b[l]`` of one config on
    one device (CUDA by default), zero until
    :func:`repro_torch.params.load_gcn` fills them."""

    def __init__(self, cfg: GCNConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dims = layer_dims(cfg)
        self.w = nn.ParameterList(nn.Parameter(torch.zeros(a, b, device=dev))
                                  for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(b, device=dev))
                                  for b in dims[1:])

    def forward(self, g: GraphBatch, *,
                aggregate_fn: Optional[Callable] = None,
                agg_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Per-node logits (N, n_classes) in f32.

        ``agg_dtype`` (e.g. bf16) casts the transformed features and the
        edge weights before aggregation; the logits return in f32.
        """
        agg = aggregate_fn or gather_scatter_sum
        coeff = sym_norm_coeffs(g)
        h = g.node_feat
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            # Transform first (cheaper aggregate); a bf16 aggregate widens
            # to the weights' dtype, as jnp's type promotion does.
            h = h.to(torch.promote_types(h.dtype, w.dtype)) @ w + b
            coeff_l = coeff
            if agg_dtype is not None:
                h = h.to(agg_dtype)
                coeff_l = coeff.to(agg_dtype)
            h = agg(g.senders_table(h), g.senders, g.receivers, g.n_nodes,
                    edge_weight=coeff_l)
            if i < self.cfg.n_layers - 1:
                h = torch.relu(h)
        return h.float()


def graph_mean(values: torch.Tensor, g: GraphBatch) -> torch.Tensor:
    """Per-graph mean of the unmasked nodes' rows, (n_graphs, ...), over
    every node rank."""
    mask = g.nmask()
    pooled = segment_sum(values * mask[:, None], g.graph_ids, g.n_graphs)
    cnt = segment_sum(mask, g.graph_ids, g.n_graphs)
    return g.node_total(pooled) / torch.clamp_min(g.node_total(cnt),
                                                  1.0)[:, None]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, total=lambda x: x
                         ) -> tuple[torch.Tensor, dict]:
    """Mean negative log-likelihood and accuracy over the unmasked rows, in
    f32; ``total`` sums the three sums over the ranks that hold the rows
    (:meth:`GraphBatch.node_total`)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll, hits, cnt = total(torch.stack([
        ((logz - gold) * mask).sum(),
        ((logits.argmax(-1) == labels) * mask).sum(), mask.sum()])).unbind()
    denom = torch.clamp_min(cnt, 1.0)
    loss = nll / denom
    return loss, {"loss": loss, "acc": hits / denom}


def loss_fn(model: GCN, g: GraphBatch, *,
            aggregate_fn: Optional[Callable] = None
            ) -> tuple[torch.Tensor, dict]:
    """Cross-entropy over the unmasked nodes, or over the graphs' mean
    logits with the ``"graphs"`` readout; ``(loss, {"loss", "acc"})``."""
    logits = model(g, aggregate_fn=aggregate_fn)
    if model.cfg.readout == "graphs":
        loss, metrics = masked_cross_entropy(
            graph_mean(logits, g), g.labels, logits.new_ones(g.n_graphs))
    else:
        loss, metrics = masked_cross_entropy(logits, g.labels, g.nmask(),
                                             g.node_total)
    return g.objective(loss), metrics
