"""GPipe pipeline parallelism over a dedicated ``pipe`` mesh axis.

For trillion-parameter configs (arctic-480b with fp32 optimizer states) a
third parallelism dimension becomes necessary; this module provides the
schedule as a composable primitive: stages hold contiguous layer groups,
microbatches stream through point-to-point hops, outputs collect on the
last stage and reach every rank by an all-reduce of the last stage's
outputs (the others add zeros).  The schedule is plain GPipe (fill + drain
bubble of (S-1)/(M+S-1)), the reference's ``gpipe_apply`` as each rank's
program.

Differentiable end to end: the backward runs the schedule in reverse,
recomputing each stage's output and sending its input gradient to the
previous stage, so ``backward()`` through :func:`gpipe_apply` runs
pipeline-parallel backpropagation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import comm

__all__ = ["gpipe_apply"]


def _shift(x: torch.Tensor, group, up: bool) -> torch.Tensor:
    """Send ``x`` one stage up (``up``) or down the line, and receive the
    neighbour's from the other side; the end that has no neighbour
    receives zeros.  Not a ring: the last stage sends nothing up."""
    n, r = comm.group_size(group), comm.group_rank(group)
    to, frm = (r + 1, r - 1) if up else (r - 1, r + 1)
    xc = x.contiguous()
    recv = torch.zeros_like(xc)
    ops = []
    if 0 <= to < n:
        ops.append(dist.P2POp(dist.isend, xc,
                              dist.get_global_rank(group, to), group))
    if 0 <= frm < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    comm._record("collective-permute", recv, group)
    return recv


class _GPipe(torch.autograd.Function):
    """The schedule as one ``Function``: the forward runs it without
    autograd, keeping each microbatch's stage input; the backward runs it
    in reverse, recomputing each stage's output (GPipe's rematerialisation)
    and sending the input gradient one stage down, as many hops as the
    forward made, so every rank's backward meets its neighbours'."""

    @staticmethod
    def forward(ctx, stage_fn, group, spec, x_micro, *leaves):
        n_stages, r = comm.group_size(group), comm.group_rank(group)
        params = tree_unflatten(list(leaves), spec)
        m = x_micro.shape[0]
        zero = torch.zeros_like(x_micro[0])
        buf, inputs = zero, {}
        outs = [zero] * m
        for t in range(m + n_stages - 1):
            y = zero
            if 0 <= t - r < m:
                inputs[t - r] = x_micro[t - r] if r == 0 else buf
                y = stage_fn(params, inputs[t - r])
            if r == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            if t < m + n_stages - 2:
                buf = _shift(y, group, True)
        ctx.stage_fn, ctx.group, ctx.spec, ctx.m = stage_fn, group, spec, m
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        # Every rank gets the last stage's outputs (the others add zeros).
        return comm.all_reduce(torch.stack(outs), group)

    @staticmethod
    def backward(ctx, grad):
        group, m = ctx.group, ctx.m
        n_stages, r = comm.group_size(group), comm.group_rank(group)
        leaves = [a.detach().requires_grad_(a.requires_grad)
                  for a in ctx.saved_tensors]
        params = tree_unflatten(leaves, ctx.spec)
        grads = [torch.zeros_like(a) for a in leaves]
        grad_x = torch.zeros((m, *grad.shape[1:]), dtype=grad.dtype,
                             device=grad.device)
        recv = torch.zeros_like(grad[0])
        for t in reversed(range(m + n_stages - 1)):
            g_y = recv
            if r == n_stages - 1:
                g_y = grad[t - (n_stages - 1)] if t >= n_stages - 1 else \
                    torch.zeros_like(grad[0])
            g_x = torch.zeros_like(grad[0])
            if 0 <= t - r < m:
                x_in = ctx.inputs[t - r].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = ctx.stage_fn(params, x_in)
                    wants = [x_in] + [a for a in leaves if a.requires_grad]
                    got = torch.autograd.grad(y, wants, g_y,
                                              allow_unused=True)
                g_x = got[0]
                it = iter(got[1:])
                for i, a in enumerate(leaves):
                    if a.requires_grad:
                        g = next(it)
                        if g is not None:
                            grads[i] += g
                if r == 0:
                    grad_x[t] = g_x
            if t > 0:
                recv = _shift(g_x, group, False)
        return (None, None, None, grad_x, *grads)


def gpipe_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *,
                group) -> torch.Tensor:
    """Run ``stage_fn`` once per stage over M microbatches.

    stage_params: this rank's stage, a tree of tensors (rank r of ``group``
    is stage r).  x_micro: (M, micro_batch, ...), the same on every rank.
    Returns (M, micro_batch, ...): the last stage's outputs, on every rank.
    Differentiable in ``x_micro`` (rank 0 holds its gradient, the other
    ranks zeros) and in the stage's tensors.
    """
    leaves, spec = tree_flatten(stage_params)
    return _GPipe.apply(stage_fn, group, spec, x_micro, *leaves)
