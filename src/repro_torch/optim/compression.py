"""int8 error-feedback gradient compression for data-parallel all-reduce
(the reference's ``optim/compression.py`` in PyTorch).

Gradients are quantized to int8 with a per-tensor scale; the quantization
error is kept in an error-feedback buffer and added back at the next step
(Karimireddy et al., arXiv:1901.09847).  ``compress_decompress`` is the
functional core, bit-identical to the reference's (``torch.round`` and
``jnp.round`` both round half to even); ``wrap_optimizer`` composes it with
any :class:`repro_torch.optim.optimizers.Optimizer`.  On one device nothing
goes over a wire: the step sees exactly the gradients an int8 all-reduce
would deliver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .optimizers import Optimizer

__all__ = ["compress_decompress", "wrap_optimizer", "CompressedState"]


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (the gradient as seen after the all-reduce, the new error)."""
    g32 = g.float() + err
    q, scale = _quantize(g32)
    deq = q.float() * scale
    return deq.to(g.dtype), g32 - deq


class CompressedState(NamedTuple):
    inner: object
    error: object


def wrap_optimizer(optimizer: Optimizer) -> Optimizer:
    def init(params):
        err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        return CompressedState(optimizer.init(params), err)

    def update(grads, state, params):
        flat_g, tdef = tree_flatten(grads)
        pairs = [compress_decompress(g, e)
                 for g, e in zip(flat_g, tree_leaves(state.error))]
        deq = tree_unflatten(tdef, [p[0] for p in pairs])
        err = tree_unflatten(tdef, [p[1] for p in pairs])
        updates, inner = optimizer.update(deq, state.inner, params)
        return updates, CompressedState(inner, err)

    return Optimizer(init=init, update=update, donate=optimizer.donate)
