"""GatedGCN (Bresson & Laurent; config from Dwivedi et al.,
arXiv:2003.00982), the reference's ``models/gnn/gatedgcn.py`` in PyTorch.

Edge-gated message passing:
    e'_ij = e_ij + ReLU(LN(C e_ij + D h_i + E h_j))
    eta_ij = sigma(e'_ij) / (sum_j' sigma(e'_ij') + eps)
    h'_i  = h_i + ReLU(LN(A h_i + sum_j eta_ij * (B h_j)))

LayerNorm replaces the original BatchNorm, as in the reference.  The
reference scans over layer-stacked weights; here each layer is a module of
its own, in the stack's order, and each layer's activations are
recomputed in the backward pass unless ``remat=False`` (the reference's
``jax.checkpoint`` of its scan body, :func:`..common.checkpoint_layer`).

On a :class:`.graph.GraphShard` (nodes and edges over every mesh axis) a
layer all-gathers ``h`` (``d_hidden`` wide) once for its two sender
reads, ``(h D)[snd]`` and ``(h B)[snd]``: half the bytes of gathering
``[h D, h B]``, for two products over the gathered rows.  ``(h E)[rcv]``
and the sums over a receiver's edges are local.  The recompute gathers
``h`` again (``"gnn_gather_remat"`` in the ledger).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...backend import resolve_device
from ..common import checkpoint_layer, gather_rows, layer_norm
from .gcn import graph_mean, masked_cross_entropy
from .graph import GraphBatch
from .layers import scatter_sum

__all__ = ["GatedGCNConfig", "GatedGCN", "GatedGCNLayer", "LAYER_KEYS",
           "loss_fn"]

#: Each layer's weights, in the reference's keys.
LAYER_KEYS = ("A", "B", "C", "D", "E", "ln_h_s", "ln_h_b", "ln_e_s",
              "ln_e_b")


@dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_in: int = 16
    d_edge_in: int = 16
    d_hidden: int = 70
    n_classes: int = 10
    readout: str = "nodes"        # "nodes" | "graphs"


class GatedGCNLayer(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        for key in "ABCDE":
            setattr(self, key, nn.Parameter(torch.zeros(d, d, device=device)))
        for key in ("ln_h_s", "ln_e_s"):
            setattr(self, key, nn.Parameter(torch.ones(d, device=device)))
        for key in ("ln_h_b", "ln_e_b"):
            setattr(self, key, nn.Parameter(torch.zeros(d, device=device)))

    def forward(self, h: torch.Tensor, e: torch.Tensor, g: GraphBatch,
                emask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        snd, rcv, n = g.senders, g.receivers, g.n_nodes
        src = g.senders_table(h)
        e_hat = (e @ self.C + gather_rows(src @ self.D, snd)
                 + (h @ self.E)[rcv])
        e = e + torch.relu(layer_norm(e_hat, self.ln_e_s, self.ln_e_b))
        eta = torch.sigmoid(e) * emask
        denom = scatter_sum(eta, rcv, n) + 1e-6
        msgs = scatter_sum(eta * gather_rows(src @ self.B, snd), rcv,
                           n) / denom
        h = h + torch.relu(layer_norm(h @ self.A + msgs, self.ln_h_s,
                                      self.ln_h_b))
        return h, e


class GatedGCN(nn.Module):
    """The f32 weights of one config on one device (CUDA by default), zero
    (LayerNorm scales one) until :func:`repro_torch.params.load_gatedgcn`
    fills them."""

    def __init__(self, cfg: GatedGCNConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.embed_h = nn.Parameter(torch.zeros(cfg.d_in, d, device=dev))
        self.embed_e = nn.Parameter(torch.zeros(cfg.d_edge_in, d, device=dev))
        self.out = nn.Parameter(torch.zeros(d, cfg.n_classes, device=dev))
        self.layers = nn.ModuleList(GatedGCNLayer(d, dev)
                                    for _ in range(cfg.n_layers))

    def forward(self, g: GraphBatch, *, remat: bool = True) -> torch.Tensor:
        """Logits: per node (N, n_classes), or per graph with the
        ``"graphs"`` readout (the nodes' mean, then the output layer).
        With ``remat`` each layer keeps only its inputs for the backward
        pass."""
        h = g.node_feat @ self.embed_h
        ef = (g.edge_feat if g.edge_feat is not None
              else h.new_ones((g.n_edges, self.cfg.d_edge_in)))
        e = ef @ self.embed_e
        emask = g.emask()[:, None]
        for layer in self.layers:
            h, e = checkpoint_layer(layer, h, e, g, emask, enabled=remat)
        if self.cfg.readout == "graphs":
            return graph_mean(h, g) @ self.out
        return h @ self.out


def loss_fn(model: GatedGCN, g: GraphBatch) -> tuple[torch.Tensor, dict]:
    """Cross-entropy over the graphs (``"graphs"`` readout) or the unmasked
    nodes; ``(loss, {"loss", "acc"})``."""
    logits = model(g)
    if model.cfg.readout == "graphs":
        loss, metrics = masked_cross_entropy(logits, g.labels,
                                             logits.new_ones(g.n_graphs))
    else:
        loss, metrics = masked_cross_entropy(logits, g.labels, g.nmask(),
                                             g.node_total)
    return g.objective(loss), metrics
