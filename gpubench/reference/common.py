"""What the references share: trees of tensors by path, message passing in
blocks of edges, and the reference's training steps (AdamW with
global-norm clipping), which give the readings the harness compares."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

#: Edges a block of :func:`spmm` and of the references' edge loops.
EDGE_BLOCK = 1 << 23


@dataclass(frozen=True)
class Leaf:
    """A weight of a layout: its shape, ``init`` ("normal", "zeros" or
    "ones") and the normal's standard deviation."""

    shape: tuple
    init: str
    std: float = 0.0


def flat(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` over nested dicts and lists (paths ``a/b/0``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflat(like, leaves: dict, prefix: str = ""):
    """The tree shaped like ``like`` holding ``leaves`` by path."""
    if isinstance(like, dict):
        return {k: unflat(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflat(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(like)]
    return leaves[prefix]


class _SpMM(torch.autograd.Function):
    """``out[r] += w_e * x[s]`` over the edges, a block at a time, and its
    transpose in the backward, so no (E, F) tensor is kept."""

    @staticmethod
    def forward(ctx, x, senders, receivers, weight, n_out):
        ctx.save_for_backward(senders, receivers, weight)
        ctx.n_in = x.shape[0]
        return _spmm(x, senders, receivers, weight, n_out)

    @staticmethod
    def backward(ctx, grad):
        senders, receivers, weight = ctx.saved_tensors
        return (_spmm(grad, receivers, senders, weight, ctx.n_in),
                None, None, None, None)


def _spmm(x, senders, receivers, weight, n_out):
    out = x.new_zeros((n_out, *x.shape[1:]))
    for lo in range(0, senders.shape[0], EDGE_BLOCK):
        hi = lo + EDGE_BLOCK
        msg = x[senders[lo:hi]] * weight[lo:hi, None]
        out.index_add_(0, receivers[lo:hi], msg)
    return out


def spmm(x, senders, receivers, weight, n_out: int) -> torch.Tensor:
    """``sum_e w_e x[senders_e]`` into each receiver: the weighted
    aggregation A @ X, in ``x``'s dtype."""
    return _SpMM.apply(x, senders, receivers, weight.to(x.dtype), n_out)


def adamw_steps(loss_fn: Callable, params: dict, batches: list, opt: dict
                ) -> dict:
    """The reference's training from ``params`` (a tree of tensors, in the
    dtype to compute in) over ``batches``, one step each: autograd's
    gradient, clipped by its global norm at ``opt["clip"]``, and AdamW
    (``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``).  Returns the
    readings: each step's loss, each leaf's first clipped gradient (on the
    host) and its norm, and each leaf's norm of the change after the last
    step."""
    start = {k: v.detach().clone() for k, v in flat(params).items()}
    cur = {k: v.detach().clone() for k, v in start.items()}
    mu = {k: torch.zeros_like(v) for k, v in cur.items()}
    nu = {k: torch.zeros_like(v) for k, v in cur.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    wd = opt.get("weight_decay", 0.0)
    losses, first_grad, first = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        diff = {k: v.requires_grad_() for k, v in cur.items()}
        loss = loss_fn(unflat(params, diff), batch)
        keys = list(diff)
        grads = torch.autograd.grad(loss, [diff[k] for k in keys],
                                    allow_unused=True)
        g = {k: (torch.zeros_like(diff[k]) if x is None else x)
             for k, x in zip(keys, grads)}
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(x.square()) for x in g.values()))
        scale = torch.clamp(opt["clip"] / (norm + 1e-9), max=1.0)
        with torch.no_grad():
            for k in keys:
                gk = g[k] * scale
                if t == 1:
                    first_grad[k] = float(torch.linalg.vector_norm(gk))
                    first[k] = gk.cpu()
                mu[k] = b1 * mu[k] + (1 - b1) * gk
                nu[k] = b2 * nu[k] + (1 - b2) * gk.square()
                du = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                if wd:
                    du = du + wd * cur[k]
                cur[k] = cur[k].detach() - lr * du
        del g, grads, loss, diff
    delta = {k: float(torch.linalg.vector_norm(cur[k] - start[k]))
             for k in cur}
    return {"loss": losses, "grad": first_grad, "grad_t": first,
            "delta": delta}


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` a layer, ReLU between the layers (none after the
    last): the MLP of the program's models."""
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def lecun_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


def he_std(fan_in: int) -> float:
    return math.sqrt(2.0 / max(fan_in, 1))
