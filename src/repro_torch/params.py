"""Weights carried across from the reference's parameter layouts.

The reference GCN keeps its parameters as ``{"w": [W_0, W_1, ...],
"b": [b_0, b_1, ...]}`` with ``W_l`` of shape ``(d_l, d_{l+1})``.  Given as
numpy arrays, :func:`gcn_combine_weights` turns them into the per-layer
combine weights W of the block-dense layer ``Y = (A @ X) @ W``.

The reference transformer keeps ``{"embed": (V, d), "final_norm": (d,),
"blocks": [one dict per window-pattern entry of (G, ...) stacks]}`` (and
``"unembed": (d, V)`` when embeddings are not tied).
:func:`transformer_params` makes seeded numpy weights in that layout and
:func:`load_transformer` turns it, or the reference's own ``init_params``
output converted with ``np.asarray``, into the port's module.  A
full-size model is drawn on the card instead, by :func:`draw_transformer`:
gemma2-2b's 2.6 B weights would take 10.4 GB of f32 host arrays.

The reference DLRM keeps ``{"tables": [(V_t, d) per feature], "bot": {"w",
"b"}, "top": {"w", "b"}}``.  :func:`dlrm_params` makes seeded numpy weights
in that layout and :func:`load_dlrm` loads them, or the reference's
``init_params`` output after ``np.asarray``, into the port's module.  (The
full-size tables are drawn on the card instead, by ``DLRM(cfg,
generator=...)``: 53 GB would not pass through host numpy in reasonable
time.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .backend import resolve_device
from .models.common import dense_init, embed_init, mlp_init
from .models.dlrm import DLRM, DLRMConfig
from .models.transformer import LAYER_KEYS, Transformer, TransformerConfig

__all__ = ["gcn_params", "gcn_combine_weights", "transformer_params",
           "load_transformer", "draw_transformer", "dlrm_params",
           "load_dlrm"]


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


def transformer_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Seeded float32 numpy parameters in the reference layout, with the
    reference's initializers: LeCun-normal matrices, 0.02-normal
    embeddings, zero norm scales (a gain of 1 + 0)."""
    rng = np.random.default_rng(seed)
    d, H, Hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    G = cfg.n_groups

    def block() -> dict:
        return {
            "ln1": np.zeros((G, d), np.float32),
            "ln2": np.zeros((G, d), np.float32),
            "wq": dense_init(rng, (G, d, H * dh), fan_in=d),
            "wk": dense_init(rng, (G, d, Hk * dh), fan_in=d),
            "wv": dense_init(rng, (G, d, Hk * dh), fan_in=d),
            "wo": dense_init(rng, (G, H * dh, d), fan_in=H * dh),
            "w_gate": dense_init(rng, (G, d, f), fan_in=d),
            "w_up": dense_init(rng, (G, d, f), fan_in=d),
            "w_down": dense_init(rng, (G, f, d), fan_in=f),
        }

    params = {"embed": embed_init(rng, (cfg.vocab, d)),
              "final_norm": np.zeros((d,), np.float32),
              "blocks": [block() for _ in cfg.window_pattern]}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(rng, (d, cfg.vocab), fan_in=d)
    return params


def _put(dst: torch.Tensor, src, what: str) -> None:
    """Copy numpy ``src`` into ``dst`` as float32; shapes must match."""
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)}, expected "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def load_transformer(params_np: dict, cfg: TransformerConfig, *,
                     device=None,
                     dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's module holding ``params_np`` (reference layout), in
    ``dtype`` (the config's compute dtype by default) on ``device`` (CUDA
    by default).  Layer ``g * P + i`` takes block ``i``'s slice ``g``;
    every shape must match exactly."""
    model = Transformer(cfg, device=resolve_device(device),
                        dtype=dtype or cfg.compute_dtype)
    P = len(cfg.window_pattern)
    if len(params_np["blocks"]) != P:
        raise ValueError(f"{len(params_np['blocks'])} blocks for a "
                         f"{P}-entry window pattern")
    with torch.no_grad():
        _put(model.embed, params_np["embed"], "embed")
        _put(model.final_norm, params_np["final_norm"], "final_norm")
        if not cfg.tie_embeddings:
            _put(model.unembed, params_np["unembed"], "unembed")
        for n, layer in enumerate(model.layers):
            g, i = divmod(n, P)
            for key in LAYER_KEYS:
                _put(getattr(layer, key),
                    np.asarray(params_np["blocks"][i][key])[g],
                    f"blocks[{i}][{key!r}][{g}]")
    return model


def draw_transformer(cfg: TransformerConfig, seed: int = 0, *,
                     device=None,
                     dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's module with seeded weights drawn in place on ``device``
    (CUDA by default), in ``dtype`` (the config's compute dtype by
    default), with the reference's initializers: LeCun-normal matrices
    (std ``1/sqrt(fan_in)``, ``fan_in`` the first dimension of the
    ``(in, out)`` layout), 0.02-normal embeddings, zero norm scales.

    The draw comes from a ``torch.Generator`` on the device seeded with
    ``seed``, in the order of the module's parameters, so it repeats on one
    device but differs from :func:`transformer_params`'s numpy draw.
    """
    model = Transformer(cfg, device=resolve_device(device),
                        dtype=dtype or cfg.compute_dtype)
    gen = torch.Generator(device=model.embed.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "embed":
                p.normal_(0.0, 0.02, generator=gen)
            elif p.dim() == 2:
                p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
    return model


def dlrm_params(cfg: DLRMConfig, seed: int = 0) -> dict:
    """Seeded float32 numpy parameters in the reference layout, with the
    reference's initializers: 0.02-normal tables, He-normal MLP weights,
    zero biases."""
    rng = np.random.default_rng(seed)
    return {"tables": [embed_init(rng, (v, cfg.embed_dim))
                       for v in cfg.vocab_sizes],
            "bot": mlp_init(rng, (cfg.n_dense,) + cfg.bot_mlp),
            "top": mlp_init(rng, (cfg.interaction_dim(),) + cfg.top_mlp)}


def load_dlrm(params_np: dict, cfg: DLRMConfig, *, device=None) -> DLRM:
    """The port's module holding ``params_np`` (reference layout) in f32 on
    ``device`` (CUDA by default); every shape and count must match."""
    model = DLRM(cfg, device=device)
    if len(params_np["tables"]) != cfg.n_sparse:
        raise ValueError(f"{len(params_np['tables'])} tables for "
                         f"{cfg.n_sparse} sparse features")
    with torch.no_grad():
        for t, (dst, src) in enumerate(zip(model.tables,
                                           params_np["tables"])):
            _put(dst, src, f"tables[{t}]")
        for name in ("bot", "top"):
            mlp = model.mlp(name)
            for key in ("w", "b"):
                srcs = params_np[name][key]
                if len(srcs) != len(mlp[key]):
                    raise ValueError(f"{name}[{key!r}]: {len(srcs)} layers, "
                                     f"expected {len(mlp[key])}")
                for i, (dst, src) in enumerate(zip(mlp[key], srcs)):
                    _put(dst, src, f"{name}[{key!r}][{i}]")
    return model
