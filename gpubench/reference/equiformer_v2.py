"""EquiformerV2 (Liao et al., arXiv:2306.12059) with eSCN's SO(2)
convolutions (Passaro and Zitnick), in plain PyTorch.

Irrep features (N, (l_max+1)^2, C), degree blocks m = -l..l.  A layer:
each degree block normed by its RMS over (m, C); graph attention from the
invariant rows, an MLP over [h_s, h_r] (ReLU between its layers) and a
softmax over each receiver's edges, a weight a head; each edge's sender
rows rotated to the edge frame (:mod:`.wigner`), the SO(2) map restricted
to |m| <= m_max (m = 0 one real product over the stacked degrees, m > 0
a complex product over the degrees l >= m), rotated back, weighed per head
and summed into the receiver; the residual; then l = 0 drives sigmoid
gates of the l > 0 blocks, and l = 0 becomes silu(s0) + FFN(silu(s0)).
The readout sums the invariant rows over the nodes into an MLP, and the
loss is the mean squared error against the graph's target.

Every layer keeps only its input for the backward pass and every block of
edges only its own (``torch.utils.checkpoint``), so float64 fits the
card.  A batch: ``x`` (N, d_in), ``senders``, ``receivers`` (E,) int64,
``positions`` (N, 3) float64, ``target`` (1, d_out); the edges are the
sample's own, without padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import wigner
from .common import Leaf, he_std, lecun_std, mlp

#: Edges a block of the convolution.
EDGE_BLOCK = 16384


def _m_dim(l: int, m_max: int) -> int:
    return min(2 * l + 1, 2 * m_max + 1)


def _n_m(model: dict, m: int) -> int:
    return (model["l_max"] + 1 - m) * model["d_hidden"]


def layout(model: dict) -> dict:
    C, lm, L = model["d_hidden"], model["l_max"], model["n_layers"]
    hd, d_out = model["n_heads"], model["d_out"]
    n0 = (lm + 1) * C

    def normal(shape, std):
        return Leaf(shape, "normal", std)

    def zeros(shape):
        return Leaf(shape, "zeros")

    layers = {"w_m0": normal((L, n0, n0), lecun_std(n0))}
    for m in range(1, model["m_max"] + 1):
        nm = _n_m(model, m)
        for part in ("r", "i"):
            layers[f"w_m{m}_{part}"] = normal((L, nm, nm), lecun_std(nm))
    layers["attn_mlp"] = {"w": [normal((L, 2 * C, C), he_std(2 * C)),
                                normal((L, C, hd), he_std(C))],
                          "b": [zeros((L, C)), zeros((L, hd))]}
    layers["gate"] = normal((L, C, lm * C), lecun_std(C))
    layers["ffn"] = {"w": [normal((L, C, 2 * C), he_std(C)),
                           normal((L, 2 * C, C), he_std(2 * C))],
                     "b": [zeros((L, 2 * C)), zeros((L, C))]}
    layers["norm_scale"] = Leaf((L, lm + 1, C), "ones")
    return {"embed": normal((model["d_in"], C), lecun_std(model["d_in"])),
            "out_mlp": {"w": [normal((C, C), he_std(C)),
                              normal((C, d_out), he_std(C))],
                        "b": [zeros((C,)), zeros((d_out,))]},
            "layers": layers}


def _slices(l_max: int):
    off = 0
    for l in range(l_max + 1):
        yield l, off, 2 * l + 1
        off += 2 * l + 1


def _norm(x, scale, model):
    parts = []
    for l, s, n in _slices(model["l_max"]):
        blk = x[:, s:s + n, :]
        rms = torch.sqrt(blk.square().sum(dim=(1, 2))
                         / (n * model["d_hidden"]) + 1e-6)
        parts.append(blk / rms[:, None, None] * scale[l][None, None, :])
    return torch.cat(parts, dim=1)


def _so2(model, lp, wig, xe):
    """Rotate, the m-restricted SO(2) map, rotate back: (B, L2, C)."""
    B, _, C = xe.shape
    L, W, mm = model["l_max"] + 1, 2 * model["m_max"] + 1, model["m_max"]
    rf = torch.stack([
        F.pad(wig[l] @ xe[:, s:s + n, :], (0, 0, 0, W - _m_dim(l, mm)))
        for l, s, n in _slices(model["l_max"])], dim=1)      # (B, L, W, C)
    rows = [(rf[:, :, 0, :].reshape(B, L * C) @ lp["w_m0"]).view(B, L, C)]
    for m in range(1, mm + 1):
        xc = rf[:, m:, 2 * m - 1, :].reshape(B, (L - m) * C)
        xs = rf[:, m:, 2 * m, :].reshape(B, (L - m) * C)
        wr, wi = lp[f"w_m{m}_r"], lp[f"w_m{m}_i"]
        for y in (xc @ wr - xs @ wi, xs @ wr + xc @ wi):
            rows.append(F.pad(y.view(B, L - m, C), (0, 0, m, 0)))
    y = torch.stack(rows, dim=2)                              # (B, L, W, C)
    return torch.cat([wig[l].transpose(1, 2) @ y[:, l, :_m_dim(l, mm), :]
                      for l in range(L)], dim=1)


def _block(h, alpha, snd, rcv, wig_list, lp_list, model, keys, n):
    lp = dict(zip(keys, lp_list))
    wig = dict(enumerate(wig_list))
    msg = _so2(model, lp, wig, h[snd])
    B, L2, C = msg.shape
    hd = model["n_heads"]
    msg = (msg.view(B, L2, hd, C // hd) * alpha[:, None, :, None]).view(
        B, L2, C)
    return msg.new_zeros((n, L2, C)).index_add(0, rcv, msg)


def _layer(x, batch, lp_list, keys, model):
    lp = dict(zip(keys, lp_list))
    n, C = x.shape[0], model["d_hidden"]
    snd, rcv = batch["senders"], batch["receivers"]
    h = _norm(x, lp["norm_scale"], model)
    h0 = h[:, 0, :]
    z = torch.cat([h0[snd], h0[rcv]], dim=1)
    scores = mlp({"w": [lp["attn_w0"], lp["attn_w1"]],
                  "b": [lp["attn_b0"], lp["attn_b1"]]}, z)       # (E, heads)
    idx = rcv[:, None].expand_as(scores)
    top = scores.new_full((n, scores.shape[1]), float("-inf")).scatter_reduce(
        0, idx, scores, "amax", include_self=True)
    ex = torch.exp(scores - top[rcv])
    alpha = ex / ex.new_zeros((n, ex.shape[1])).index_add(0, rcv, ex)[rcv]
    so2_keys = [k for k in keys if k.startswith("w_m")]
    agg = None
    for lo in range(0, snd.shape[0], EDGE_BLOCK):
        hi = lo + EDGE_BLOCK
        wig = [batch["wigner"][l][lo:hi] for l in range(model["l_max"] + 1)]
        part = checkpoint(_block, h, alpha[lo:hi], snd[lo:hi], rcv[lo:hi],
                          wig, [lp[k] for k in so2_keys], model, so2_keys, n,
                          use_reentrant=False)
        agg = part if agg is None else agg + part
    x = x + agg
    s0 = x[:, 0, :]
    gates = torch.sigmoid(s0 @ lp["gate"]).view(n, model["l_max"], C)
    x0 = F.silu(s0)
    out = [(x0 + mlp({"w": [lp["ffn_w0"], lp["ffn_w1"]],
                      "b": [lp["ffn_b0"], lp["ffn_b1"]]}, x0))[:, None, :]]
    for l, s, k in list(_slices(model["l_max"]))[1:]:
        out.append(x[:, s:s + k, :] * gates[:, l - 1][:, None, :])
    return torch.cat(out, dim=1)


def _layer_params(layers: dict, i: int) -> dict:
    out = {k: v[i] for k, v in layers.items() if torch.is_tensor(v)}
    for name, short in (("attn_mlp", "attn"), ("ffn", "ffn")):
        for j, w in enumerate(layers[name]["w"]):
            out[f"{short}_w{j}"] = w[i]
        for j, b in enumerate(layers[name]["b"]):
            out[f"{short}_b{j}"] = b[i]
    return out


def prepare(batch: dict, model: dict, dtype) -> dict:
    """The batch with each edge's Wigner blocks, worked out from the
    positions in float64 and cast to ``dtype``."""
    pos = batch["positions"].to(torch.float64)
    vec = pos[batch["senders"]] - pos[batch["receivers"]]
    wig = wigner.blocks(vec, model["l_max"], model["m_max"])
    return {**batch, "wigner": {l: w.to(dtype) for l, w in wig.items()}}


def predict(params: dict, batch: dict, model: dict) -> torch.Tensor:
    dtype = params["embed"].dtype
    if "wigner" not in batch:
        batch = prepare(batch, model, dtype)
    n, C = batch["x"].shape[0], model["d_hidden"]
    L2 = (model["l_max"] + 1) ** 2
    s0 = batch["x"].to(dtype) @ params["embed"]
    x = torch.cat([s0[:, None, :], s0.new_zeros((n, L2 - 1, C))], dim=1)
    for i in range(model["n_layers"]):
        lp = _layer_params(params["layers"], i)
        keys = list(lp)
        x = checkpoint(_layer, x, batch, [lp[k] for k in keys], keys, model,
                       use_reentrant=False)
    pooled = x[:, 0, :].sum(dim=0, keepdim=True)
    return mlp(params["out_mlp"], pooled)


def loss(params: dict, batch: dict, model: dict) -> torch.Tensor:
    pred = predict(params, batch, model)
    return (pred - batch["target"].to(pred.dtype)).square().mean()


def _macs(model: dict, n_nodes: int, n_edges: int) -> float:
    """Multiply-adds of one forward on real nodes and edges."""
    C, lm, mm = model["d_hidden"], model["l_max"], model["m_max"]
    hd = model["n_heads"]
    rot = sum(_m_dim(l, mm) * (2 * l + 1) for l in range(lm + 1)) * C
    n0 = (lm + 1) * C
    so2 = n0 ** 2 + sum(4 * _n_m(model, m) ** 2 for m in range(1, mm + 1))
    per_edge = 2 * rot + so2 + C * hd
    per_node = 2 * C * C + C * lm * C + 4 * C * C
    return (n_nodes * model["d_in"] * C
            + model["n_layers"] * (n_edges * per_edge + n_nodes * per_node)
            + C * C + C * model["d_out"])


def flops(model: dict, n_nodes: int, n_edges: int) -> float:
    """3x the forward's 2 x multiply-adds: the embedding; a layer's
    rotation and un-rotation, the SO(2) map (m = 0 one real product, each
    m > 0 four real products of its complex one), the attention's second
    product per edge and its first per node (the senders' and receivers'
    halves), the gates and the FFN per node; the readout."""
    return 3.0 * 2.0 * _macs(model, n_nodes, n_edges)


def aggregate_bytes(model: dict, n_nodes: int, n_edges: int) -> float:
    """A layer's gather of the senders' rows into (E, L2, C) messages and
    scatter-sum of the weighted messages into the receivers, forward and
    backward (each the other's transpose), f32: the gather reads the N
    rows and writes the E rows, the scatter reads the E rows and writes
    the N rows, each reads its E int64 ids once.  The attention's
    gathers and the softmax's sums are not counted (E x heads)."""
    row = (model["l_max"] + 1) ** 2 * model["d_hidden"] * 4
    per = 2.0 * (n_nodes * row + n_edges * row + n_edges * 8)
    return model["n_layers"] * 2.0 * per
