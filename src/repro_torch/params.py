"""GCN weights carried across from the reference's parameter layout.

The reference GCN keeps its parameters as ``{"w": [W_0, W_1, ...],
"b": [b_0, b_1, ...]}`` with ``W_l`` of shape ``(d_l, d_{l+1})``.  Given as
numpy arrays, :func:`gcn_combine_weights` turns them into the per-layer
combine weights W of the block-dense layer ``Y = (A @ X) @ W``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .backend import resolve_device

__all__ = ["gcn_params", "gcn_combine_weights"]


def gcn_params(dims: Sequence[int], seed: int = 0) -> dict:
    """Seeded numpy parameters in the reference layout: LeCun-normal
    weights (std ``1/sqrt(fan_in)``), zero biases."""
    rng = np.random.default_rng(seed)
    return {"w": [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
                  for a, b in zip(dims[:-1], dims[1:])],
            "b": [np.zeros((b,), np.float32) for b in dims[1:]]}


def gcn_combine_weights(params_np: dict, *, device=None,
                        dtype: torch.dtype = torch.float32
                        ) -> list[torch.Tensor]:
    """Per-layer W tensors, contiguous, on ``device`` (CUDA by default).

    The layer kernels compute ``(A @ X) @ W`` and carry no bias, so a
    nonzero bias raises instead of being dropped.  Consecutive widths must
    chain.
    """
    dev = resolve_device(device)
    ws = [np.asarray(w) for w in params_np["w"]]
    for a, b in zip(ws[:-1], ws[1:]):
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"layer widths do not chain: {a.shape} -> "
                             f"{b.shape}")
    for i, b in enumerate(params_np.get("b", ())):
        if np.any(np.asarray(b) != 0):
            raise ValueError(f"layer {i} has a nonzero bias; the layer "
                             "kernels compute (A @ X) @ W without one")
    return [torch.tensor(w, dtype=dtype, device=dev).contiguous()
            for w in ws]
