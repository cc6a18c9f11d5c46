"""Optimizers: AdamW and SGD with schedules and global-norm clipping (the
reference's ``optim/optimizers.py`` in PyTorch).

The same functional form over trees of tensors (:mod:`repro_torch.tree`)::

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

and the same order of operations, so each leaf rounds as the reference's
does: the schedule is read at ``step + 1`` in f32 tensors, clipping scales
by ``max_norm / (norm + 1e-9)`` inside ``update``, moments are kept in
``state_dtype`` with their arithmetic in f32, and the update is ``-lr_t *
(mh / (sqrt(vh) + eps) + wd * p)``, added to ``p`` by
:func:`apply_updates` (two roundings).  ``torch.optim.AdamW`` rounds
otherwise: it decays ``p`` first and adds ``eps`` after dividing
``sqrt(v)`` by ``sqrt(bc2)``.

``adamw(donate=True)`` writes the new moments into the old state's buffers,
and the clipped gradients and the updates into the gradients' buffers, as
``jax.jit``'s ``donate_argnums`` would let XLA do: the caller's gradients
and old state are spent by the call.  With :func:`apply_updates`'s
``donate`` the parameters take their update in place too, so a step holds
one copy of the parameters, gradients and both moments (DLRM's 12.4 GB of
tables would otherwise need twice that).  The rounding is the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..obs import STEP, SYNC, UPDATE, span
from ..tree import (tree_flatten, tree_leaves, tree_map, tree_unflatten,
                    value_and_grad)

__all__ = ["Optimizer", "AdamWState", "SGDState", "adamw", "sgd",
           "apply_updates", "make_step", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup"]

PyTree = object


@dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``.  ``donate`` says ``update`` spends its gradients
    and state, and the train steps then apply the updates in place."""

    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    donate: bool = False


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def global_norm(tree: PyTree) -> torch.Tensor:
    """The f32 square root of the leaves' summed squares, summed leaf by
    leaf in the reference's flatten order."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float, *,
                        donate: bool = False,
                        norm: Optional[torch.Tensor] = None
                        ) -> tuple[PyTree, torch.Tensor]:
    """Every leaf times ``min(1, max_norm / (norm + 1e-9))``, and the norm;
    in the leaves' own buffers with ``donate``.  ``norm`` is the tree's
    global norm when the caller has it (a sharded tree's, from
    ``distributed.sharding.sharded_global_norm``), else
    :func:`global_norm`."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: torch.mul(x, scale.to(x.dtype),
                                        out=x if donate else None),
                    tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``final_frac * base_lr`` at ``total``; evaluated in f32."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_warmup(base_lr: float, warmup: int
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        return base_lr * torch.clamp(step.to(torch.float32) / max(warmup, 1),
                                     max=1.0)
    return lr


def _constant(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0,
          state_dtype: torch.dtype = torch.float32,
          donate: bool = False) -> Optimizer:
    """AdamW.  Moment math always runs in f32; states are stored in
    ``state_dtype``.  ``donate`` (f32 states only) reuses the gradients'
    and the old moments' buffers for the results."""
    if donate and state_dtype != torch.float32:
        raise ValueError("donate reuses the moments' buffers for their f32 "
                         "values: it needs f32 states")
    lr_fn = lr if callable(lr) else _constant(lr)

    def init(params: PyTree) -> AdamWState:
        zeros = lambda: tree_map(
            lambda x: torch.zeros_like(x, dtype=state_dtype), params)
        return AdamWState(torch.zeros((), dtype=torch.int32,
                                      device=_device(params)),
                          zeros(), zeros())

    def update(grads: PyTree, state: AdamWState, params: PyTree, *,
               norm: Optional[torch.Tensor] = None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, donate=donate,
                                           norm=norm)
        step = state.step + 1
        stepf = step.to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        neg_lr = -lr_fn(step)

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = torch.add(b1 * m.float(), (1 - b1) * g32,
                            out=m if donate else None)
            v32 = torch.add(b2 * v.float(), (1 - b2) * torch.square(g32),
                            out=v if donate else None)
            du = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
            if weight_decay:
                du.add_(weight_decay * p.float())
            # (-lr_t * du).astype(p.dtype), into g's buffer when donated.
            u = torch.mul(neg_lr, du, out=g if donate else None)
            return u.to(p.dtype), m32.to(state_dtype), v32.to(state_dtype)

        flat_g, tdef = tree_flatten(grads)
        for name, tree in (("mu", state.mu), ("nu", state.nu),
                           ("params", params)):
            if tree_flatten(tree)[1] != tdef:
                raise ValueError(f"{name} is not shaped like the gradients")
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            flat_g, tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]
        updates = tree_unflatten(tdef, [o[0] for o in out])
        mu = tree_unflatten(tdef, [o[1] for o in out])
        nu = tree_unflatten(tdef, [o[2] for o in out])
        return updates, AdamWState(step, mu, nu)

    return Optimizer(init=init, update=update, donate=donate)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-2, *,
        momentum: float = 0.9,
        clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = lr if callable(lr) else _constant(lr)

    def init(params: PyTree) -> SGDState:
        return SGDState(torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                        tree_map(lambda x: torch.zeros_like(
                            x, dtype=torch.float32), params))

    def update(grads: PyTree, state: SGDState, params: PyTree, *,
               norm: Optional[torch.Tensor] = None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm=norm)
        step = state.step + 1
        lr_t = lr_fn(step)
        mom = tree_map(lambda g, m: momentum * m + g.float(), grads,
                       state.momentum)
        updates = tree_map(lambda p, m: (-lr_t * m).to(p.dtype), params, mom)
        return updates, SGDState(step, mom)

    return Optimizer(init=init, update=update)


def apply_updates(params: PyTree, updates: PyTree, *,
                  donate: bool = False) -> PyTree:
    """``p + u`` leaf by leaf, into ``p``'s buffer with ``donate``."""
    return tree_map(lambda p, u: torch.add(p, u.to(p.dtype),
                                           out=p if donate else None),
                    params, updates)


def make_step(loss: Callable, optimizer: Optimizer, *,
              sync: Optional[Callable] = None) -> Callable:
    """``step_fn(state, batch) -> (state, metrics)`` over ``state = (params,
    opt_state)``, from ``loss(params, batch) -> (loss, metrics)``:
    autograd's gradients, the optimizer's update, applied in place when the
    optimizer donates.  ``sync(grads) -> norm`` (a sharded step's) makes
    one rank's gradients whole in place and returns their global norm,
    which the update's clipping reads.  Its halves stay reachable as
    ``step_fn.grad_fn`` and ``step_fn.optimizer`` (to time or check them
    apart).  A step runs in the span ``step``, the sync in ``step.sync``
    and the update in ``step.update`` (:mod:`repro_torch.obs`)."""
    grad_fn = value_and_grad(loss)

    def step_fn(state, batch):
        with span(STEP):
            params, opt_state = state
            (_, metrics), grads = grad_fn(params, batch)
            kw = {}
            if sync is not None:
                with span(SYNC):
                    kw["norm"] = sync(grads)
            with span(UPDATE):
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params, **kw)
                params = apply_updates(params, updates,
                                       donate=optimizer.donate)
        return (params, opt_state), metrics

    step_fn.grad_fn, step_fn.optimizer = grad_fn, optimizer
    return step_fn
