"""Functional building blocks of the port's models (copied from the
reference's ``models/common.py``, in PyTorch).

Norms and rotary embeddings compute in fp32 and cast back to the input's
dtype, as the reference does.  The initializers are NumPy, seeded by a
``numpy.random.Generator``, so weights come out identical on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["dense_init", "he_init", "embed_init", "rms_norm", "layer_norm",
           "softcap", "mlp_init", "mlp_apply", "rope_freqs", "apply_rope"]


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
