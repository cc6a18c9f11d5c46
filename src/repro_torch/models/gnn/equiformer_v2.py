"""EquiformerV2-style equivariant graph attention via eSCN SO(2)
convolutions (Liao et al., arXiv:2306.12059; the eSCN trick from Passaro &
Zitnick): the reference's ``models/gnn/equiformer_v2.py`` in PyTorch.

Irrep features are packed (N, (l_max+1)^2, C).  Each edge rotates the source
features so the edge vector aligns with +z (the per-edge real-Wigner blocks
are data, made on the host by :mod:`repro_torch.data.wigner`), applies an
SO(2)-equivariant linear map restricted to |m| <= m_max (the O(L^6) ->
O(L^3) reduction that defines eSCN), un-rotates, weighs the result by graph
attention from the invariant l=0 channel, and scatter-sums to receivers.
As in the reference: no S2-grid pointwise activation, and a plain invariant
FFN on l=0.

Data contract: edges must have non-zero edge vectors (self-loops have no
edge frame and break equivariance), and padding edges carry
``edge_mask = 0`` so their arbitrary Wigner blocks never contribute.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...backend import resolve_device
from ..common import MLP, segment_softmax, segment_sum
from .graph import GraphBatch

__all__ = ["EquiformerV2Config", "EquiformerV2", "EquiformerV2Layer",
           "equivariant_rms_norm", "loss_fn"]


@dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128           # channels per irrep degree
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 4                 # scalar input features per node (atom embed)
    d_out: int = 1                # invariant readout (energy)
    # The eSCN convolution processes edges in this many chunks, bounding the
    # (E_chunk, L2, C) message tensor.
    edge_chunks: int = 1

    @property
    def L2(self) -> int:
        return (self.l_max + 1) ** 2

    def m_dim(self, l: int) -> int:
        return min(2 * l + 1, 2 * self.m_max + 1)

    def ls_for_m(self, m: int) -> list[int]:
        return list(range(max(m, 1) if m > 0 else 0, self.l_max + 1))


def _l_slices(l_max: int) -> list[tuple[int, int]]:
    """(start, size) of each degree block in the packed (l_max+1)^2 axis."""
    out, off = [], 0
    for l in range(l_max + 1):
        out.append((off, 2 * l + 1))
        off += 2 * l + 1
    return out


class EquiformerV2Layer(nn.Module):
    """One layer's weights, in the reference's keys: ``w_m0`` and
    ``w_m{m}_r`` / ``w_m{m}_i`` (the SO(2) maps), ``attn_mlp``, ``gate``,
    ``ffn`` and ``norm_scale``."""

    def __init__(self, cfg: EquiformerV2Config, device):
        super().__init__()
        C, lm = cfg.d_hidden, cfg.l_max
        n0 = (lm + 1) * C
        self.w_m0 = nn.Parameter(torch.zeros(n0, n0, device=device))
        for m in range(1, cfg.m_max + 1):
            nm = len(cfg.ls_for_m(m)) * C
            for part in ("r", "i"):
                setattr(self, f"w_m{m}_{part}",
                        nn.Parameter(torch.zeros(nm, nm, device=device)))
        self.attn_mlp = MLP([2 * C, C, cfg.n_heads], device=device)
        self.gate = nn.Parameter(torch.zeros(C, lm * C, device=device))
        self.ffn = MLP([C, 2 * C, C], device=device)
        self.norm_scale = nn.Parameter(torch.ones(lm + 1, C, device=device))


def equivariant_rms_norm(cfg: EquiformerV2Config, x: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Normalize each degree block by its RMS norm over (m, C)."""
    parts = []
    for l, (s, n) in enumerate(_l_slices(cfg.l_max)):
        blk = x[:, s:s + n, :]
        rms = torch.sqrt(blk.square().mean(dim=(1, 2), keepdim=True) + 1e-6)
        parts.append(blk / rms * scale[l][None, None, :])
    return torch.cat(parts, dim=1)


def _so2_conv(cfg: EquiformerV2Config, lp: EquiformerV2Layer, rot: dict,
              x_edge: torch.Tensor) -> torch.Tensor:
    """Rotate -> SO(2) linear (m-restricted) -> un-rotate.  x_edge (E, L2, C);
    ``rot`` maps l to the (E, m_dim, 2l+1) Wigner blocks."""
    C = x_edge.shape[2]
    slices = _l_slices(cfg.l_max)

    # Rotate into the edge-aligned frame, keeping only |m| <= m_max rows.
    rot_feats = [torch.einsum("emn,enc->emc", rot[l], x_edge[:, s:s + n, :])
                 for l, (s, n) in enumerate(slices)]

    # Row layout within each l block (wigner_stack): [m=0, 1c, 1s, 2c, ...]
    def row(l: int, m: int, part: str) -> torch.Tensor:
        if m == 0:
            return rot_feats[l][:, 0, :]
        base = 1 + 2 * (m - 1)
        return rot_feats[l][:, base + (0 if part == "c" else 1), :]

    out_rows: dict[int, dict] = {l: {} for l in range(cfg.l_max + 1)}

    # m = 0: plain linear over stacked (l, C).
    x0 = torch.cat([row(l, 0, "c") for l in range(cfg.l_max + 1)], dim=-1)
    y0 = x0 @ lp.w_m0
    for i, l in enumerate(range(cfg.l_max + 1)):
        out_rows[l][(0, "c")] = y0[:, i * C:(i + 1) * C]

    # m >= 1: complex linear (commutes with the residual z-rotation gauge).
    for m in range(1, cfg.m_max + 1):
        ls = cfg.ls_for_m(m)
        xc = torch.cat([row(l, m, "c") for l in ls], dim=-1)
        xs = torch.cat([row(l, m, "s") for l in ls], dim=-1)
        wr, wi = getattr(lp, f"w_m{m}_r"), getattr(lp, f"w_m{m}_i")
        yc = xc @ wr - xs @ wi
        ys = xs @ wr + xc @ wi
        for i, l in enumerate(ls):
            out_rows[l][(m, "c")] = yc[:, i * C:(i + 1) * C]
            out_rows[l][(m, "s")] = ys[:, i * C:(i + 1) * C]

    # Reassemble the m-restricted blocks and rotate back with D^T.
    outs = []
    for l in range(cfg.l_max + 1):
        rows = [out_rows[l][(0, "c")]]
        for m in range(1, min(l, cfg.m_max) + 1):
            rows.extend([out_rows[l][(m, "c")], out_rows[l][(m, "s")]])
        y = torch.stack(rows, dim=1)                 # (E, m_dim, C)
        outs.append(torch.einsum("emn,emc->enc", rot[l], y))
    return torch.cat(outs, dim=1)                    # (E, L2, C)


class EquiformerV2(nn.Module):
    """The f32 weights of one config on one device (CUDA by default), zero
    (norm scales one) until :func:`repro_torch.params.load_equiformer_v2`
    fills them."""

    def __init__(self, cfg: EquiformerV2Config, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        C = cfg.d_hidden
        self.embed = nn.Parameter(torch.zeros(cfg.d_in, C, device=dev))
        self.out_mlp = MLP([C, C, cfg.d_out], device=dev)
        self.layers = nn.ModuleList(EquiformerV2Layer(cfg, dev)
                                    for _ in range(cfg.n_layers))

    def _chunks(self, g: GraphBatch, alpha: torch.Tensor) -> list[tuple]:
        """(wigner, senders, receivers, alpha) per edge chunk.  The data
        pipeline may deliver the Wigner blocks pre-chunked, (n_chunks, Ec,
        m_dim, 2l+1); else ``cfg.edge_chunks`` splits the edges when it
        divides them, and one chunk takes all of them when it does not."""
        E = g.n_edges
        pre_chunked = next(iter(g.wigner.values())).dim() == 4
        if pre_chunked:
            n_chunks = next(iter(g.wigner.values())).shape[0]
        else:
            n_chunks = (self.cfg.edge_chunks
                        if E % max(self.cfg.edge_chunks, 1) == 0 else 1)
        if n_chunks == 1 and not pre_chunked:
            return [(g.wigner, g.senders, g.receivers, alpha)]
        ec = E // n_chunks
        out = []
        for c in range(n_chunks):
            lo, hi = c * ec, (c + 1) * ec
            wig = {l: (w[c] if pre_chunked else w[lo:hi])
                   for l, w in g.wigner.items()}
            out.append((wig, g.senders[lo:hi], g.receivers[lo:hi],
                        alpha[lo:hi]))
        return out

    def _layer(self, lp: EquiformerV2Layer, x: torch.Tensor,
               g: GraphBatch, emask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        N, C = g.n_nodes, cfg.d_hidden
        snd, rcv = g.senders, g.receivers
        h = equivariant_rms_norm(cfg, x, lp.norm_scale)
        # Attention from the invariant channels, over the full edge set.
        h0 = h[:, 0, :]
        scores = lp.attn_mlp(torch.cat([h0[snd], h0[rcv]], dim=-1))
        scores = torch.where(emask[:, None] > 0, scores,
                             scores.new_tensor(-1e30))
        alpha = segment_softmax(scores, rcv, N) * emask[:, None]
        agg = None
        for wig_c, snd_c, rcv_c, alpha_c in self._chunks(g, alpha):
            msg = _so2_conv(cfg, lp, wig_c, h[snd_c])
            mh = msg.reshape(msg.shape[0], cfg.L2, cfg.n_heads,
                             C // cfg.n_heads)
            mh = mh * alpha_c[:, None, :, None]
            part = segment_sum(mh.reshape(msg.shape[0], cfg.L2, C), rcv_c, N)
            agg = part if agg is None else agg + part
        x = x + agg
        # Gated nonlinearity: l=0 drives sigmoid gates for l > 0.
        s0 = x[:, 0, :]
        gates = torch.sigmoid(s0 @ lp.gate).reshape(N, cfg.l_max, C)
        parts = [F.silu(s0)[:, None, :]]
        for l, (s, n) in enumerate(_l_slices(cfg.l_max)[1:], start=1):
            parts.append(x[:, s:s + n, :] * gates[:, l - 1][:, None, :])
        x = torch.cat(parts, dim=1)
        # Invariant FFN on l=0.
        x0 = x[:, 0, :]
        return torch.cat([(x0 + lp.ffn(x0))[:, None, :], x[:, 1:, :]], dim=1)

    def forward(self, g: GraphBatch) -> torch.Tensor:
        """Invariant per-graph predictions (n_graphs, d_out)."""
        cfg = self.cfg
        N = g.n_nodes
        s0 = g.node_feat @ self.embed
        x = torch.cat([s0[:, None, :],
                       s0.new_zeros((N, cfg.L2 - 1, cfg.d_hidden))], dim=1)
        emask = g.emask()
        for lp in self.layers:
            x = self._layer(lp, x, g, emask)
        inv = x[:, 0, :] * g.nmask()[:, None]
        gid = (g.graph_ids if g.graph_ids is not None
               else torch.zeros(N, dtype=torch.long, device=inv.device))
        return self.out_mlp(segment_sum(inv, gid, g.n_graphs))


def loss_fn(model: EquiformerV2, g: GraphBatch
            ) -> tuple[torch.Tensor, dict]:
    """Mean squared error of the per-graph predictions, in f32;
    ``(loss, {"loss", "mae"})``."""
    pred = model(g)
    loss = (pred - g.labels).float().square().mean()
    return loss, {"loss": loss, "mae": (pred - g.labels).abs().mean()}
