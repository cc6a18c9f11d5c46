"""GCN (Kipf and Welling, arXiv:1609.02907) in plain PyTorch.

h^{l+1} = act(D_in^{-1/2} (A + I) D_out^{-1/2} h^l W^l + b^l) over the
edge list as given (self-loops are edges of the graph), ReLU between the
layers, and the mean cross-entropy over the nodes in the loss.  The
transform comes before the aggregation, as in the paper's order of
operations for d_hidden < d_in.

A batch: ``x`` (N, d_in), ``senders`` and ``receivers`` (E,) int64,
``labels`` (N,) int64 and ``mask`` (N,), the nodes in the loss.
"""

from __future__ import annotations

import torch

from .common import Leaf, lecun_std, spmm


def dims(model: dict) -> list[int]:
    return ([model["d_in"]] + [model["d_hidden"]] * (model["n_layers"] - 1)
            + [model["n_classes"]])


def layout(model: dict) -> dict:
    d = dims(model)
    return {"w": [Leaf((a, b), "normal", lecun_std(a))
                  for a, b in zip(d[:-1], d[1:])],
            "b": [Leaf((b,), "zeros") for b in d[1:]]}


def sym_norm(senders, receivers, n: int, dtype) -> torch.Tensor:
    """1 / sqrt(d_in(r) d_out(s)) of each edge, from the edge list."""
    d_in = torch.bincount(receivers, minlength=n).to(dtype)
    d_out = torch.bincount(senders, minlength=n).to(dtype)
    return torch.rsqrt(d_in)[receivers] * torch.rsqrt(d_out)[senders]


def logits(params: dict, batch: dict) -> torch.Tensor:
    dtype = params["w"][0].dtype
    n = batch["x"].shape[0]
    coeff = sym_norm(batch["senders"], batch["receivers"], n, dtype)
    h = batch["x"].to(dtype)
    layers = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = spmm(h @ w + b, batch["senders"], batch["receivers"], coeff, n)
        if i < layers - 1:
            h = torch.relu(h)
    return h


def loss(params: dict, batch: dict, model: dict) -> torch.Tensor:
    z = logits(params, batch)
    nll = torch.logsumexp(z, dim=-1) - z.gather(
        1, batch["labels"][:, None])[:, 0]
    mask = batch["mask"].to(z.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def flops(model: dict, n_nodes: int, n_edges: int) -> float:
    """3x the forward: each layer's transform (2 N a b) and aggregation
    (2 E b, a multiply and an add an edge and feature)."""
    d = dims(model)
    fwd = sum(2.0 * n_nodes * a * b + 2.0 * n_edges * b
              for a, b in zip(d[:-1], d[1:]))
    return 3.0 * fwd


def aggregate_bytes(model: dict, n_nodes: int, n_edges: int) -> float:
    """Each layer's aggregation A @ H in the forward and its transpose in
    the backward, f32 rows: the N rows read and the N rows written, and
    each edge's sender and receiver (int64) and weight (f32) read once.
    The degrees and the weights are not counted (a few N and E reads)."""
    d = dims(model)
    per = [2.0 * n_nodes * b * 4 + n_edges * (8 + 8 + 4) for b in d[1:]]
    return 2.0 * sum(per)
