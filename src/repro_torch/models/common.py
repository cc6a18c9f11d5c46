"""Functional building blocks of the port's models (copied from the
reference's ``models/common.py``, in PyTorch).

Norms and rotary embeddings compute in fp32 and cast back to the input's
dtype, as the reference does.  The initializers are NumPy, seeded by a
``numpy.random.Generator``, so weights come out identical on every device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed import comm
from ..obs import (GATHER_ROWS, RECOMPUTE, SEGMENT_SOFTMAX, SEGMENT_SUM,
                   span)
from ..tree import tree_leaves

__all__ = ["Initializer", "dense_init", "he_init", "embed_init", "rms_norm", "layer_norm",
           "softcap", "swiglu", "mlp_init", "mlp_apply", "MLP", "rope_freqs",
           "apply_rope", "segment_sum", "gather_rows", "segment_softmax",
           "cross_entropy_loss", "count_params", "checkpoint_layer",
           "REMAT_TAG"]


def _fan(shape: Sequence[int], fan_in: Optional[int]) -> int:
    """``fan_in``, or the second-to-last dimension (the last of a vector)."""
    fan = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    return max(fan, 1)


def dense_init(rng: np.random.Generator, shape: Sequence[int], *,
               fan_in: Optional[int] = None) -> np.ndarray:
    """LeCun-normal float32 weights: std ``1 / sqrt(fan_in)``, with
    ``fan_in`` the second-to-last dimension unless given."""
    std = 1.0 / math.sqrt(_fan(shape, fan_in))
    return rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(std)


def he_init(rng: np.random.Generator, shape: Sequence[int], *,
            fan_in: Optional[int] = None) -> np.ndarray:
    """He-normal float32 weights: std ``sqrt(2 / fan_in)``, with ``fan_in``
    the second-to-last dimension unless given."""
    std = math.sqrt(2.0 / _fan(shape, fan_in))
    return rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(std)


def embed_init(rng: np.random.Generator, shape: Sequence[int]) -> np.ndarray:
    return rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(0.02)


#: The reference's name for the default matrix initializer.
Initializer = dense_init


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a ``(1 + scale)`` gain, in fp32, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with a plain gain, in fp32, cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    return cap * torch.tanh(x / cap)


def swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: h (..., g, d); weights (..., d, f) / (..., f, d)."""
    return (torch.nn.functional.silu(h @ w_gate) * (h @ w_up)) @ w_down


def mlp_init(rng: np.random.Generator, dims: Sequence[int], *,
             layer_norm_out: bool = False) -> dict:
    """``{"w": [(a, b) He-normal], "b": [(b,) zeros]}`` for consecutive
    widths, plus a unit LayerNorm on the output when asked."""
    params = {"w": [he_init(rng, (a, b)) for a, b in zip(dims[:-1], dims[1:])],
              "b": [np.zeros((b,), np.float32) for b in dims[1:]]}
    if layer_norm_out:
        params["ln_scale"] = np.ones((dims[-1],), np.float32)
        params["ln_bias"] = np.zeros((dims[-1],), np.float32)
    return params


def mlp_apply(params, x: torch.Tensor, *, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` after every layer but the last (and
    after the last too with ``final_act``), then the optional LayerNorm.
    ``params`` maps ``"w"`` and ``"b"`` to sequences of tensors."""
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    if "ln_scale" in params:
        x = layer_norm(x, params["ln_scale"], params["ln_bias"])
    return x


class MLP(nn.Module):
    """The weights of one :func:`mlp_init` MLP as f32 parameters on one
    device: ``w`` and ``b`` per layer, and ``ln_scale`` / ``ln_bias`` when
    it ends in a LayerNorm.  They start at zero (the scales at one) until
    the caller loads them; :meth:`forward` is :func:`mlp_apply`."""

    def __init__(self, dims: Sequence[int], *, layer_norm_out: bool = False,
                 device=None):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(torch.zeros(a, b, device=device))
            for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(b, device=device))
                                  for b in dims[1:])
        if layer_norm_out:
            self.ln_scale = nn.Parameter(torch.ones(dims[-1], device=device))
            self.ln_bias = nn.Parameter(torch.zeros(dims[-1], device=device))

    def params(self) -> dict:
        """``{"w": [...], "b": [...]}`` (and the LayerNorm's), the layout
        :func:`mlp_apply` reads."""
        p = {"w": list(self.w), "b": list(self.b)}
        if hasattr(self, "ln_scale"):
            p["ln_scale"], p["ln_bias"] = self.ln_scale, self.ln_bias
        return p

    def forward(self, x: torch.Tensor, *, final_act: bool = False
                ) -> torch.Tensor:
        return mlp_apply(self.params(), x, final_act=final_act)


def rope_freqs(d_head: int, *, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq).  Rotates the
    two halves of the head dimension (not interleaved pairs), fp32 angles."""
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: Elements widened to float64 at a time by :func:`segment_sum` (512 MB).
SEGMENT_SUM_CHUNK = 1 << 26


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Rows of ``values`` summed per segment (``index_add_`` over int64
    ``segment_ids``), returned in ``values``' dtype.

    The sums accumulate in float64, a chunk of rows at a time.  A float32
    sum stops counting at 2^24 equal terms and loses about 5% over the 2.7e7
    edges into the hub of a 6.2e7-edge power-law graph, in whatever order
    the rows arrive; the reference's ``segment_sum`` accumulates in the
    values' dtype, so the two differ only where that rounding shows.
    """
    with span(SEGMENT_SUM):
        acc = torch.zeros((num_segments, *values.shape[1:]),
                          dtype=torch.float64, device=values.device)
        step = max(1, SEGMENT_SUM_CHUNK // max(1, math.prod(
            values.shape[1:])))
        for lo in range(0, values.shape[0], step):
            acc.index_add_(0, segment_ids[lo:lo + step],
                           values[lo:lo + step].double())
        return acc.to(values.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.n), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (int64 ``idx``), whose backward sums each row's gradients
    with :func:`segment_sum`: in float64, by ``index_add_``.  The backward
    of ``x[idx]`` sorts the ids and sums each run of equal ids in one warp:
    on the card that took 28.3 s of a GCN step at ogb_products, whose hub
    sends 2.7e7 edges."""
    with span(GATHER_ROWS):
        return _GatherRows.apply(x, idx)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over variable-size segments (the edge softmax), shifted by
    each segment's maximum.  ``segment_ids`` is int64 (``scatter_reduce_``
    takes no other).  A segment with no member has no maximum: it starts
    at ``-inf``, which is then mapped to 0, as the reference maps
    ``segment_max``'s empty segments."""
    with span(SEGMENT_SOFTMAX):
        idx = segment_ids.view(-1, *([1] * (logits.dim() - 1))).expand_as(
            logits)
        seg_max = logits.new_full((num_segments, *logits.shape[1:]),
                                  float("-inf"))
        seg_max = seg_max.scatter_reduce(0, idx, logits, "amax",
                                         include_self=True)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                              torch.zeros_like(seg_max))
        expd = torch.exp(logits - seg_max[segment_ids])
        seg_sum = segment_sum(expd, segment_ids, num_segments)
        return expd / (seg_sum[segment_ids] + 1e-9)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level cross-entropy in fp32: the mean over the tokens, or over
    the ``mask``'s weight (at least 1) when one is given."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def count_params(tree) -> int:
    """The number of elements over a tree's leaves (tensors or arrays)."""
    return sum(int(x.numel() if torch.is_tensor(x) else np.size(x))
               for x in tree_leaves(tree) if hasattr(x, "shape"))


#: Appended to the ledger tag of every collective a recompute re-issues
#: (``"gnn_gather"`` becomes ``"gnn_gather_remat"``).
REMAT_TAG = "_remat"


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can bind ``module``'s weights for it."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def _rebound(bound: _Bound, weights: dict, *args):
    return torch.func.functional_call(
        bound, {f"module.{k}": v for k, v in weights.items()}, args)


@contextlib.contextmanager
def _recomputing():
    with span(RECOMPUTE), comm.retagged(REMAT_TAG):
        yield


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def checkpoint_layer(module: nn.Module, *args, fn: Optional[Callable] = None,
                     enabled: bool = True):
    """``fn(module, *args)`` (``module(*args)`` by default), its
    activations recomputed in the backward pass: the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)``, as a non-reentrant
    ``torch.utils.checkpoint`` that keeps only the inputs.  A plain call
    when not ``enabled`` or when grad is off.

    A tree bound to the model by ``torch.func.functional_call``
    (``params.tree_loss``) is bound only while that call runs, and the
    recompute runs after it has returned: it would read the module's own
    weights and give wrong gradients with no error.  So the tensors that
    stand for ``module``'s parameters are taken here, in the forward, and
    the recompute binds the same tensors again.  The collectives the
    recompute issues are recorded under their tag and :data:`REMAT_TAG`,
    and the recompute runs in the span ``remat.recompute``.
    The layers draw no random numbers, so no generator state is kept."""
    call = fn or nn.Module.__call__
    if not (enabled and torch.is_grad_enabled()):
        return call(module, *args)
    weights = dict(module.named_parameters())
    return checkpoint(_rebound, _Bound(module, call), weights, *args,
                      use_reentrant=False, preserve_rng_state=False,
                      context_fn=_remat_contexts)
