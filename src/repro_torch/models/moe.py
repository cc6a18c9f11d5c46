"""Mixture-of-Experts FFN: routing and capacity dispatch (the reference's
``models/moe.py``, single device).

Two execution paths, one semantics:

* :func:`moe_ffn_reference`: every expert processes every token, then a
  gated combine.  O(E) overcompute; the numerical oracle in the tests and
  the decode path (at decode batch sizes every expert is hit anyway, and
  the step reads every expert's weights).
* :func:`moe_ffn_capacity`: capacity-bucketed dispatch.  Tokens gather into
  an ``(E, C, d)`` buffer, the experts run as batched products, and each
  token sums its ``k`` gated results.  Active-only products (times the
  capacity factor); the prefill and ``forward`` path.

Over-capacity assignments are dropped (Switch / GShard semantics).  The
order that decides which ones is the reference's: assignments flatten
``(token, k)`` token-major, an assignment's slot is its rank among the
earlier assignments to the same expert, and the ones at rank >= C drop.

* :func:`moe_ffn_ep`: expert parallelism, one rank's program.  The
  rank's tokens pack into per-destination capacity buckets ``(ep, E_loc,
  C, d)``, go to the experts' owners by an all-to-all (dispatch), pass
  through the rank's own ``E_loc`` experts, and come back by a second
  all-to-all (combine): the traffic
  ``repro_torch.core.comm_model.moe_dispatch_sync`` models.  On one rank
  it is :func:`moe_ffn_capacity` bit for bit.

No TPU kernel computes any of this: routing, dispatch and the expert
products are plain PyTorch, as the reference's are XLA.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..backend import resolve_device
from .common import dense_init, swiglu

__all__ = ["MoEConfig", "MoE", "MOE_KEYS", "router_topk", "moe_ffn_reference",
           "moe_ffn_capacity", "moe_ffn_ep", "init_moe_params"]

#: The expert weights, in the reference's param-dict names.
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Snowflake-Arctic-style dense residual MLP running in parallel with the
    # experts (d_ff of that branch); None disables it.
    dense_residual_d_ff: Optional[int] = None
    aux_loss_weight: float = 0.01


class MoE(nn.Module):
    """One layer's experts: ``router (d, E)``, ``w_gate`` and ``w_up (E, d,
    f)``, ``w_down (E, f, d)``, zeros until loaded or drawn, on CUDA unless
    ``device`` says otherwise.  ``moe[key]`` reads a weight by its reference
    name, so the functions below take this module or a dict of tensors
    alike."""

    def __init__(self, d_model: int, cfg: MoEConfig, *, device=None,
                 dtype=None):
        super().__init__()
        E, f = cfg.n_experts, cfg.d_ff_expert
        dev = resolve_device(device)
        shapes = {"router": (d_model, E), "w_gate": (E, d_model, f),
                  "w_up": (E, d_model, f), "w_down": (E, f, d_model)}
        for key in MOE_KEYS:
            setattr(self, key, nn.Parameter(
                torch.zeros(shapes[key], device=dev, dtype=dtype),
                requires_grad=False))

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in MOE_KEYS:
            raise KeyError(key)
        return getattr(self, key)


@contextmanager
def _ieee_fp32():
    """fp32 products in full fp32 for the scope: a router logit rounded
    through TF32 can flip a top-k choice, which moves the slot of every
    later assignment to both experts."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """Softmax-then-top-k routing with renormalized gates (Qwen3/Mixtral).

    The product runs in fp32 on the router weight as given (the caller's
    compute dtype, as the reference casts its blocks first).  Returns
    (expert_idx (T, k) int32, gates (T, k) fp32, aux_loss scalar)."""
    with _ieee_fp32():
        logits = x.float() @ w_router.float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance auxiliary loss.
    me = probs.mean(dim=0)                                         # (E,)
    # A scatter of ones (not bincount, whose output size depends on the
    # data and which a fake trace cannot run): the same integer counts.
    flat = expert_idx.reshape(-1)
    ce = torch.zeros(cfg.n_experts, dtype=flat.dtype, device=flat.device
                     ).scatter_add_(0, flat, torch.ones_like(flat)).to(
        torch.float32) / x.shape[0]
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.aux_loss_weight
    return expert_idx.to(torch.int32), gates, aux


#: The SwiGLU expert, under the reference's name.
_expert_ffn = swiglu


def moe_ffn_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                      cfg: MoEConfig, *, experts: slice = slice(None)):
    """All-expert compute with gated combine.  x: (T, d).

    ``experts``: the experts whose weights ``params`` holds (an expert
    parallel rank's slice, the router whole); the result is then their
    share of the combine, which the ranks' shares sum to."""
    expert_idx, gates, aux = router_topk(x, params["router"], cfg)
    # (E, T, d): every expert sees every token.
    h = _expert_ffn(x[None], params["w_gate"], params["w_up"],
                    params["w_down"])
    weights = torch.zeros(x.shape[0], cfg.n_experts, dtype=torch.float32,
                          device=x.device).scatter_add_(
        1, expert_idx.long(), gates).to(x.dtype)                   # (T, E)
    out = torch.einsum("te,etd->td", weights[:, experts], h)
    return out, aux


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    return max(1, math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


def _pack_assignments(x: torch.Tensor, expert_idx: torch.Tensor,
                      gates: torch.Tensor, n_experts: int, capacity: int):
    """Flatten (token, k) assignments token-major and compute per-expert
    slot positions: an assignment's rank among the earlier ones to its
    expert, from an int32 one-hot running count.

    The one-hot is laid out expert-major, ``(E, A)``, and counted as one
    flat run (a single-pass scan on the card); an assignment's rank is its
    entry of that run less the count at its expert's row start.  A scan
    down the ``A`` rows of an ``(A, E)`` one-hot gives the same ranks, but
    walks each column serially on the card (about 190 ms a layer at
    qwen3-moe's 524,288 assignments on an H100).

    Returns (token_of_assignment, flat_expert, slot, keep, flat_gate);
    ``slot`` is 0 where ``keep`` is false, as in the reference."""
    T, k = expert_idx.shape
    flat_e = expert_idx.reshape(-1)                                 # (A,)
    flat_g = gates.reshape(-1)
    token_of = torch.arange(T, dtype=torch.int32,
                            device=x.device).repeat_interleave(k)
    experts = torch.arange(n_experts, dtype=flat_e.dtype, device=x.device)
    onehot = (experts[:, None] == flat_e[None, :]).to(torch.int32)  # (E, A)
    running = torch.cumsum(onehot.view(-1), dim=0,
                           dtype=torch.int32).view(onehot.shape)
    del onehot
    starts = torch.cat([running.new_zeros(1), running[:-1, -1]])    # (E,)
    e = flat_e.long()
    pos = running[e, torch.arange(e.numel(), device=x.device)] - starts[e] - 1
    keep = pos < capacity
    slot = torch.where(keep, pos, 0)
    return token_of, flat_e, slot, keep, flat_g


def _dispatch_buffer(x: torch.Tensor, token_of, flat_e, slot, keep,
                     n_experts: int, capacity: int) -> torch.Tensor:
    """The ``(E, C, d)`` buffer: which token fills each slot, T (the zero
    row) where none does; dropped assignments write to a spare slot past
    the buffer."""
    T, d = x.shape
    E, C = n_experts, capacity
    fills = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    fills[torch.where(keep, flat_e.long() * C + slot, E * C)] = \
        token_of.long()
    return torch.cat([x, x.new_zeros(1, d)])[fills[:-1]].view(E, C, d)


def moe_ffn_capacity(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     cfg: MoEConfig):
    """Single-device capacity-bucketed dispatch.  x: (T, d).

    The ``(E, C, d)`` buffer is gathered by plain indexing (each kept
    assignment owns its slot; an empty slot reads a zero row), and each
    token's ``k`` gated results are contiguous, so the combine is a sum over
    ``k``: no atomics, deterministic on the card."""
    T, d = x.shape
    E, C = cfg.n_experts, _capacity(T, cfg)
    expert_idx, gates, aux = router_topk(x, params["router"], cfg)
    token_of, flat_e, slot, keep, flat_g = _pack_assignments(
        x, expert_idx, gates, E, C)
    buf = _dispatch_buffer(x, token_of, flat_e, slot, keep, E, C)
    out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                          params["w_down"])
    del buf  # 2.7 GB at qwen3-moe's B 2 x 32,768: freed before y_a
    weight = (keep.to(torch.float32) * flat_g).to(x.dtype)
    y_a = out_buf.view(E * C, d)[flat_e.long() * C + slot] * weight[:, None]
    del out_buf
    return y_a.view(T, cfg.top_k, d).sum(dim=1), aux


def moe_ffn_ep(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg: MoEConfig, *, group):
    """Expert-parallel dispatch, one rank's program.

    x: this rank's (T_loc, d) tokens; ``params``: the replicated router and
    this rank's slice ``(E_loc, ...)`` of the expert weights (rank j of
    ``group`` owns experts ``j * E_loc ..``).  The capacity C comes from
    the local T.  Two all-to-alls of ``(ep, E_loc, C, d)`` buckets move
    them to and from the experts' owners; the balance loss, computed on the
    local routing, is averaged over the group."""
    from ..distributed import comm

    ep = comm.group_size(group)
    E = cfg.n_experts
    if E % ep:
        raise ValueError(f"{E} experts over {ep} ranks")
    E_loc = E // ep
    T, d = x.shape
    C = _capacity(T, cfg)
    expert_idx, gates, aux = router_topk(x, params["router"], cfg)
    token_of, flat_e, slot, keep, flat_g = _pack_assignments(
        x, expert_idx, gates, E, C)
    send = _dispatch_buffer(x, token_of, flat_e, slot, keep, E, C).view(
        ep, E_loc, C, d)
    recv = comm.all_to_all(send, group)       # (ep_src, E_loc, C, d)
    del send
    # (ep_src, E_loc, C, d) -> (E_loc, ep_src * C, d): the local experts.
    h = recv.transpose(0, 1).reshape(E_loc, ep * C, d)
    out = _expert_ffn(h, params["w_gate"], params["w_up"], params["w_down"])
    del h, recv
    back = out.view(E_loc, ep, C, d).transpose(0, 1)
    ret = comm.all_to_all(back, group)        # (ep_dst, E_loc, C, d)
    weight = (keep.to(torch.float32) * flat_g).to(x.dtype)
    y_a = ret.reshape(E * C, d)[flat_e.long() * C + slot] * weight[:, None]
    aux = comm.all_reduce(aux, group) / ep
    return y_a.view(T, cfg.top_k, d).sum(dim=1), aux


def init_moe_params(rng: np.random.Generator, d_model: int,
                    cfg: MoEConfig) -> dict:
    """Seeded float32 numpy weights with the reference's initializers:
    LeCun-normal, ``fan_in`` d for the router, ``w_gate`` and ``w_up``, f
    for ``w_down``."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    return {
        "router": dense_init(rng, (d_model, E)),
        "w_gate": dense_init(rng, (E, d_model, f), fan_in=d_model),
        "w_up": dense_init(rng, (E, d_model, f), fan_in=d_model),
        "w_down": dense_init(rng, (E, f, d_model), fan_in=f),
    }
