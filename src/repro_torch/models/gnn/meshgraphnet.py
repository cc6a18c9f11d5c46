"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode (the
reference's ``models/gnn/meshgraphnet.py`` in PyTorch).

Processor step (x15, d=128, 2-layer MLPs with LayerNorm):
    e'_ij = e_ij + MLP_e([e_ij, h_i, h_j])
    h'_i  = h_i + MLP_v([h_i, sum_j e'_ij])
The decoder regresses per-node targets (mesh dynamics).  The reference
scans over layer-stacked processors; here each is a module of its own, in
the stack's order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...backend import resolve_device
from ..common import MLP
from .graph import GraphBatch
from .layers import scatter_sum

__all__ = ["MeshGraphNetConfig", "MeshGraphNet", "mlp_dims", "loss_fn"]


@dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15            # processor message-passing steps
    d_in: int = 12                # node input features (velocity, type, ...)
    d_edge_in: int = 4            # relative displacement + norm
    d_hidden: int = 128
    mlp_layers: int = 2
    d_out: int = 3                # predicted acceleration / field delta


def mlp_dims(cfg: MeshGraphNetConfig, d_in: int) -> list[int]:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


class Processor(nn.Module):
    def __init__(self, cfg: MeshGraphNetConfig, device):
        super().__init__()
        d = cfg.d_hidden
        self.edge_mlp = MLP(mlp_dims(cfg, 3 * d), layer_norm_out=True,
                            device=device)
        self.node_mlp = MLP(mlp_dims(cfg, 2 * d), layer_norm_out=True,
                            device=device)

    def forward(self, h: torch.Tensor, e: torch.Tensor, g: GraphBatch,
                emask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        snd, rcv = g.senders, g.receivers
        e = e + self.edge_mlp(torch.cat([e, h[snd], h[rcv]], dim=-1),
                              final_act=True)
        agg = scatter_sum(e * emask, rcv, g.n_nodes)
        h = h + self.node_mlp(torch.cat([h, agg], dim=-1), final_act=True)
        return h, e


class MeshGraphNet(nn.Module):
    """The f32 weights of one config on one device (CUDA by default), zero
    (LayerNorm scales one) until :func:`repro_torch.params.
    load_meshgraphnet` fills them."""

    def __init__(self, cfg: MeshGraphNetConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.node_enc = MLP(mlp_dims(cfg, cfg.d_in), layer_norm_out=True,
                            device=dev)
        self.edge_enc = MLP(mlp_dims(cfg, cfg.d_edge_in),
                            layer_norm_out=True, device=dev)
        self.decoder = MLP([d] * cfg.mlp_layers + [cfg.d_out], device=dev)
        self.processors = nn.ModuleList(Processor(cfg, dev)
                                        for _ in range(cfg.n_layers))

    def forward(self, g: GraphBatch) -> torch.Tensor:
        """Per-node predictions (N, d_out)."""
        h = self.node_enc(g.node_feat, final_act=True)
        ef = (g.edge_feat if g.edge_feat is not None
              else h.new_ones((g.n_edges, self.cfg.d_edge_in)))
        e = self.edge_enc(ef, final_act=True)
        emask = g.emask()[:, None]
        for proc in self.processors:
            h, e = proc(h, e, g, emask)
        return self.decoder(h)


def loss_fn(model: MeshGraphNet, g: GraphBatch) -> tuple[torch.Tensor, dict]:
    """Mean squared error over the unmasked nodes' outputs, in f32;
    ``(loss, {"loss", "rmse"})``."""
    pred = model(g)
    mask = g.nmask()[:, None]
    err = (pred - g.labels).float().square() * mask
    loss = err.sum() / torch.clamp_min(mask.sum() * model.cfg.d_out, 1.0)
    return loss, {"loss": loss, "rmse": torch.sqrt(loss)}
