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

Activations are recomputed in the backward pass, as the reference's
``jax.checkpoint``s recompute them (:func:`..common.checkpoint_layer`):
each layer keeps only its input unless ``remat=False``, and when the edges
come in chunks each chunk's convolution and scatter keep only theirs, so
the chunk loop does not hold every chunk's messages for the backward.

On a :class:`.graph.GraphShard` the nodes and edges lie over the dp
axes and, when the ``model`` ranks divide them, the channels over
``model`` (2-D GNN partitioning, the reference's
``P(dp, None, model)`` node state): each rank holds its node block's
``(N_block, L2, C / tp)`` slice and the slice of every weight it reads.
The senders' table is all-gathered once a layer, outside the chunk loop,
``L2 * C / tp`` wide (the paper's one feature all-gather a layer; the
reference lets GSPMD place it), and again in the layer's recompute
(``"gnn_gather_remat"``).  Every sum over the channel ranks is taken over
node rows, never per edge (``"gnn_tp"``): each degree's sum of squares in
the norm; the attention MLP's first product, split into per-node senders'
and receivers' halves (the senders' half gathered like the table); the
SO(2) maps, row-parallel over the rank's input channels, whose
full-width partial messages stay partial through the un-rotation, the
attention weights and the receivers' sum (all linear) and are
reduce-scattered once a layer; and the invariant rows that drive the
gate and the FFN on l = 0, all-gathered whole, from which each rank
takes the gates and FFN outputs of its own channels.  The readout gathers
the pooled invariant rows whole before ``out_mlp``.  With whole channels
(one channel rank, or one device) every one of these is an identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...backend import resolve_device
from ...obs import (EQV2_ATTENTION, EQV2_GATE_FFN, EQV2_NORM, EQV2_SO2_CONV,
                    span)
from ..common import (MLP, checkpoint_layer, gather_rows, mlp_apply,
                      segment_softmax, segment_sum)
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
                         scale: torch.Tensor,
                         channel_sum=None) -> torch.Tensor:
    """Normalize each degree block by its RMS norm over (m, C).  ``x`` may
    hold a slice of the channels, and ``scale`` its slice: ``channel_sum``
    (a shard's :meth:`~.graph.GraphBatch.channel_sum`) then totals each
    degree's sum of squares over the ranks that hold the others, (N,
    l_max + 1) a rank, and the mean is over all ``cfg.d_hidden``."""
    with span(EQV2_NORM):
        slices = _l_slices(cfg.l_max)
        sq = torch.stack([x[:, s:s + n, :].square().sum(dim=(1, 2))
                          for s, n in slices], dim=1)
        if channel_sum is not None:
            sq = channel_sum(sq)
        parts = []
        for l, (s, n) in enumerate(slices):
            rms = torch.sqrt(sq[:, l, None, None] / (n * cfg.d_hidden)
                             + 1e-6)
            parts.append(x[:, s:s + n, :] / rms * scale[l][None, None, :])
        return torch.cat(parts, dim=1)


def _rows(w: torch.Tensor, blocks: int, lo: int, hi: int) -> torch.Tensor:
    """The rows of ``w`` ((blocks x C), out) that read channels ``lo`` to
    ``hi`` of each block: a view of all of ``w`` when they are all."""
    return w.reshape(blocks, -1, w.shape[1])[:, lo:hi].reshape(
        blocks * (hi - lo), w.shape[1])


def _so2_conv(cfg: EquiformerV2Config, lp: EquiformerV2Layer, rot: dict,
              x_edge: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Rotate -> SO(2) linear (m-restricted) -> un-rotate.  x_edge (E, L2,
    Cl) holds channels ``lo`` to ``lo + Cl``; ``rot`` maps l to the (E,
    m_dim, 2l+1) Wigner blocks.  Returns the (E, L2, C) messages over all
    ``cfg.d_hidden`` output channels: the whole product when Cl is all of
    them, else this slice's share (the maps row-parallel over it).

    Each degree's rotated rows are padded to the widest block's 2 m_max + 1
    and stacked, (E, l_max + 1, 2 m_max + 1, Cl), so that one (m, part) row
    over the degrees is one strided slice: the reference's row-by-row
    selections and concatenations, in fewer operations."""
    with span(EQV2_SO2_CONV):
        E, _, Cl = x_edge.shape
        C = cfg.d_hidden
        hi = lo + Cl
        L, W = cfg.l_max + 1, 2 * cfg.m_max + 1

        # Rotate into the edge-aligned frame, keeping only |m| <= m_max
        # rows.  Row layout within each l block (wigner_stack): [m=0, 1c,
        # 1s, 2c, ...]
        rot_feats = torch.stack([
            F.pad(torch.bmm(rot[l], x_edge[:, s:s + n, :]),
                  (0, 0, 0, W - cfg.m_dim(l)))
            for l, (s, n) in enumerate(_l_slices(cfg.l_max))], dim=1)

        # m = 0: plain linear over stacked (l, C).
        outs = [(rot_feats[:, :, 0, :].reshape(E, L * Cl)
                 @ _rows(lp.w_m0, L, lo, hi)).view(E, L, C)]

        # m >= 1: complex linear (commutes with the residual z-rotation
        # gauge), over the degrees l >= m, zero rows in front for l < m.
        for m in range(1, cfg.m_max + 1):
            xc = rot_feats[:, m:, 2 * m - 1, :].reshape(E, (L - m) * Cl)
            xs = rot_feats[:, m:, 2 * m, :].reshape(E, (L - m) * Cl)
            wr, wi = (_rows(getattr(lp, f"w_m{m}_{part}"), L - m, lo, hi)
                      for part in ("r", "i"))
            for y in (xc @ wr - xs @ wi, xs @ wr + xc @ wi):
                outs.append(F.pad(y.view(E, L - m, C), (0, 0, m, 0)))
        y = torch.stack(outs, dim=2)                     # (E, L, W, C)

        # Rotate back with D^T, each degree over its m-restricted rows.
        return torch.cat([
            torch.bmm(rot[l].transpose(1, 2), y[:, l, :cfg.m_dim(l), :])
            for l in range(L)], dim=1)                   # (E, L2, C)


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

    def _weighted_scatter(self, lp: EquiformerV2Layer, wig: dict,
                          snd: torch.Tensor, rcv: torch.Tensor,
                          alpha: torch.Tensor, src: torch.Tensor,
                          N: int, lo: int) -> torch.Tensor:
        """One chunk's messages from the senders' table ``src`` (channels
        ``lo`` on), weighed by ``alpha`` per head and summed into the
        ``N`` receivers, over all the output channels (a partial sum when
        ``src`` holds a slice)."""
        cfg = self.cfg
        C = cfg.d_hidden
        msg = _so2_conv(cfg, lp, wig, gather_rows(src, snd), lo)
        mh = msg.reshape(msg.shape[0], cfg.L2, cfg.n_heads, C // cfg.n_heads)
        mh = mh * alpha[:, None, :, None]
        return segment_sum(mh.reshape(msg.shape[0], cfg.L2, C), rcv, N)

    def _attention(self, lp: EquiformerV2Layer, h0: torch.Tensor,
                   g: GraphBatch, emask: torch.Tensor) -> torch.Tensor:
        """The (E, heads) attention weights from the normed invariant rows
        ``h0`` (this rank's channels): the reference's MLP over [h_s0,
        h_r0] with its first product taken per node, ``h_s0 @ W_a`` and
        ``h_r0 @ W_b`` over the rank's channels summed over the channel
        ranks, the senders' half gathered as the table is."""
        C = self.cfg.d_hidden
        lo, hi = g.channels(C)
        w, b = list(lp.attn_mlp.w), list(lp.attn_mlp.b)
        with span(EQV2_ATTENTION):
            p = g.channel_sum(h0 @ torch.cat([w[0][lo:hi],
                                              w[0][C + lo:C + hi]], dim=1))
            z = torch.relu(gather_rows(g.senders_table(p[:, :C]), g.senders)
                           + p[:, C:][g.receivers] + b[0])
            scores = mlp_apply({"w": w[1:], "b": b[1:]}, z)
            scores = torch.where(emask[:, None] > 0, scores,
                                 scores.new_tensor(-1e30))
            return segment_softmax(scores, g.receivers, g.n_nodes) * \
                emask[:, None]

    def _layer(self, lp: EquiformerV2Layer, x: torch.Tensor,
               g: GraphBatch, emask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        N, C = g.n_nodes, cfg.d_hidden
        lo, hi = g.channels(C)
        h = equivariant_rms_norm(cfg, x, lp.norm_scale[:, lo:hi],
                                 g.channel_sum)
        # The node gather, once a layer (over the node ranks).
        src = g.senders_table(h)
        # Attention from the invariant channels, over the full edge set.
        alpha = self._attention(lp, h[:, 0, :], g, emask)
        chunks = self._chunks(g, alpha)
        agg = None
        for wig_c, snd_c, rcv_c, alpha_c in chunks:
            part = checkpoint_layer(lp, wig_c, snd_c, rcv_c, alpha_c, src, N,
                                    lo, fn=self._weighted_scatter,
                                    enabled=len(chunks) > 1)
            agg = part if agg is None else agg + part
        x = x + g.channel_scatter(agg, 2)
        with span(EQV2_GATE_FFN):
            # Gated nonlinearity: l=0 drives sigmoid gates for l > 0.  The
            # invariant rows, whole: each rank computes its channels' gates.
            s0 = g.channel_gather(x[:, 0, :], 1)
            gate = lp.gate.reshape(C, cfg.l_max, C)[:, :, lo:hi]
            gates = torch.sigmoid(s0 @ gate.reshape(C, -1)).reshape(
                N, cfg.l_max, hi - lo)
            x0 = F.silu(s0)
            # Invariant FFN on l=0, on whole rows, kept at this rank's
            # channels.
            parts = [(x0[:, lo:hi] + lp.ffn(x0)[:, lo:hi])[:, None, :]]
            for l, (s, n) in enumerate(_l_slices(cfg.l_max)[1:], start=1):
                parts.append(x[:, s:s + n, :] * gates[:, l - 1][:, None, :])
            return torch.cat(parts, dim=1)

    def forward(self, g: GraphBatch, *, remat: bool = True) -> torch.Tensor:
        """Invariant per-graph predictions (n_graphs, d_out).  With
        ``remat`` each layer keeps only its input for the backward pass."""
        cfg = self.cfg
        N = g.n_nodes
        lo, hi = g.channels(cfg.d_hidden)
        s0 = g.node_feat @ self.embed[:, lo:hi]
        x = torch.cat([s0[:, None, :],
                       s0.new_zeros((N, cfg.L2 - 1, hi - lo))], dim=1)
        emask = g.emask()
        for lp in self.layers:
            x = checkpoint_layer(lp, x, g, emask, fn=self._layer,
                                 enabled=remat)
        inv = x[:, 0, :] * g.nmask()[:, None]
        gid = (g.graph_ids if g.graph_ids is not None
               else torch.zeros(N, dtype=torch.long, device=inv.device))
        pooled = g.node_total(segment_sum(inv, gid, g.n_graphs))
        return self.out_mlp(g.channel_gather(pooled, 1))


def loss_fn(model: EquiformerV2, g: GraphBatch
            ) -> tuple[torch.Tensor, dict]:
    """Mean squared error of the per-graph predictions, in f32;
    ``(loss, {"loss", "mae"})``."""
    pred = model(g)
    loss = (pred - g.labels).float().square().mean()
    return g.objective(loss), {"loss": loss,
                               "mae": (pred - g.labels).abs().mean()}
