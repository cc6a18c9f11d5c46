"""Weights carried across from the reference's parameter layouts.

The reference GCN keeps its parameters as ``{"w": [W_0, W_1, ...],
"b": [b_0, b_1, ...]}`` with ``W_l`` of shape ``(d_l, d_{l+1})``.  Given as
numpy arrays, :func:`gcn_combine_weights` turns them into the per-layer
combine weights W of the block-dense layer ``Y = (A @ X) @ W``.

The reference transformer keeps ``{"embed": (V, d), "final_norm": (d,),
"blocks": [one dict per window-pattern entry of (G, ...) stacks]}`` (and
``"unembed": (d, V)`` when embeddings are not tied).  An MoE block holds
``"moe": {"router": (G, d, E), "w_gate", "w_up": (G, E, d, f), "w_down":
(G, E, f, d)}`` in place of the dense FFN, and ``res_gate`` / ``res_up`` /
``res_down`` when the config has a dense residual branch.
:func:`transformer_params` makes seeded numpy weights in that layout and
:func:`load_transformer` turns it, or the reference's own ``init_params``
output converted with ``np.asarray``, into the port's module.  A
full-size model is drawn on the card instead, by :func:`draw_transformer`:
gemma2-2b's 2.6 B weights would take 10.4 GB of f32 host arrays, and
qwen3-moe-30b-a3b's 30.2 B 121 GB.

The reference DLRM keeps ``{"tables": [(V_t, d) per feature], "bot": {"w",
"b"}, "top": {"w", "b"}}``.  :func:`dlrm_params` makes seeded numpy weights
in that layout and :func:`load_dlrm` loads them, or the reference's
``init_params`` output after ``np.asarray``, into the port's module.  (The
full-size tables are drawn on the card instead, by ``DLRM(cfg,
generator=...)``: 53 GB would not pass through host numpy in reasonable
time.)

The reference GNNs keep their weights as pytrees whose per-layer leaves are
stacked along a leading ``L`` axis (its models scan over layers):
GatedGCN's ``{"embed_h", "embed_e", "out", "layers": {"A", ..., "ln_e_b"}}``,
MeshGraphNet's ``{"node_enc", "edge_enc", "decoder", "processors":
{"edge_mlp", "node_mlp"}}`` of :func:`mlp_init` MLPs, EquiformerV2's
``{"embed", "out_mlp", "layers": {"w_m0", "w_m{m}_r", "w_m{m}_i",
"attn_mlp", "gate", "ffn", "norm_scale"}}``, and GCN's ``{"w", "b"}``
lists.  :func:`gnn_params` draws seeded numpy weights in those layouts with
the reference's initializers, and :func:`load_gcn`, :func:`load_gatedgcn`,
:func:`load_meshgraphnet` and :func:`load_equiformer_v2` load them, or the
reference's ``init_params`` output after ``np.asarray``, into the port's
modules: layer ``i`` takes slice ``i`` of every stacked leaf.
:func:`gnn_tree` gives a GNN's training tree on a device, from such a
numpy tree or drawn from a seed: the same on every rank of a policy that
replicates the GNN's state.

The reverse direction serves training, whose state is a tree of tensors in
the reference's layout (so a checkpoint holds the reference's leaves, in its
order).  :func:`module_tree` gives a port module's weights as such a tree
(stacked where the reference stacks), :func:`dump_transformer`,
:func:`dump_dlrm` and :func:`dump_gnn` as the reference's numpy tree,
:func:`tensor_tree` puts a numpy tree on a device, :func:`to_numpy` takes a
training state ``(params, opt_state)`` back to numpy leaf for leaf, and
:func:`tree_loss` evaluates a module's loss with its weights read from a
tree (stacked leaves unbound), so autograd differentiates the tree.
Serving modules keep ``requires_grad=False``: training never
differentiates a module's own weights.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .backend import resolve_device
from .models.common import dense_init, embed_init, mlp_init
from .distributed.sharding import shard_slices, spec_axes
from .models.dlrm import DLRM, DLRMConfig, ShardedDLRM
from .models.dlrm import param_pspecs as dlrm_pspecs
from .models.gnn.equiformer_v2 import EquiformerV2, EquiformerV2Config
from .models.gnn.gatedgcn import LAYER_KEYS as GATEDGCN_KEYS
from .models.gnn.gatedgcn import GatedGCN, GatedGCNConfig
from .models.gnn.gcn import GCN, GCNConfig, layer_dims
from .models.gnn.meshgraphnet import MeshGraphNet, MeshGraphNetConfig, mlp_dims
from .models.moe import MOE_KEYS, init_moe_params
from .models.transformer import (ShardedTransformer, Transformer,
                                 TransformerConfig, layer_keys)
from .models.transformer import param_pspecs as transformer_pspecs
from .tree import (is_spec, tree_flatten, tree_leaves, tree_map, tree_paths,
                   tree_unflatten)

__all__ = ["gcn_params", "gcn_combine_weights", "transformer_params",
           "load_transformer", "draw_transformer", "dlrm_params",
           "load_dlrm", "gnn_params", "load_gcn", "load_gatedgcn",
           "load_meshgraphnet", "load_equiformer_v2", "gnn_tree",
           "module_tree", "dump_transformer", "dump_dlrm", "dump_gnn",
           "tensor_tree", "to_numpy", "bind", "tree_loss",
           "shard_transformer", "shard_transformer_tree", "shard_dlrm"]


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

    def ffn(width: int, prefix: str) -> dict:
        return {f"{prefix}gate": dense_init(rng, (G, d, width), fan_in=d),
                f"{prefix}up": dense_init(rng, (G, d, width), fan_in=d),
                f"{prefix}down": dense_init(rng, (G, width, d),
                                            fan_in=width)}

    def block() -> dict:
        blk = {
            "ln1": np.zeros((G, d), np.float32),
            "ln2": np.zeros((G, d), np.float32),
            "wq": dense_init(rng, (G, d, H * dh), fan_in=d),
            "wk": dense_init(rng, (G, d, Hk * dh), fan_in=d),
            "wv": dense_init(rng, (G, d, Hk * dh), fan_in=d),
            "wo": dense_init(rng, (G, H * dh, d), fan_in=H * dh),
        }
        if cfg.moe is None:
            return {**blk, **ffn(f, "w_")}
        experts = [init_moe_params(rng, d, cfg.moe) for _ in range(G)]
        blk["moe"] = {key: np.stack([e[key] for e in experts])
                      for key in MOE_KEYS}
        if cfg.moe.dense_residual_d_ff:
            blk.update(ffn(cfg.moe.dense_residual_d_ff, "res_"))
        return blk

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
    by default).  Layer ``g * P + i`` takes block ``i``'s slice ``g`` (of
    every expert weight too); every shape must match exactly."""
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
            block = params_np["blocks"][i]
            expect = set(layer_keys(cfg)) | ({"moe"} if cfg.moe else set())
            if set(block) != expect:
                raise ValueError(f"blocks[{i}] holds {sorted(block)}, "
                                 f"expected {sorted(expect)}")
            for key in layer_keys(cfg):
                _put(getattr(layer, key), np.asarray(block[key])[g],
                     f"blocks[{i}][{key!r}][{g}]")
            if cfg.moe is not None:
                for key in MOE_KEYS:
                    _put(layer.moe[key], np.asarray(block["moe"][key])[g],
                         f"blocks[{i}]['moe'][{key!r}][{g}]")
    return model


def draw_transformer(cfg: TransformerConfig, seed: int = 0, *,
                     device=None,
                     dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's module with seeded weights drawn in place on ``device``
    (CUDA by default), in ``dtype`` (the config's compute dtype by
    default), with the reference's initializers: LeCun-normal matrices
    (std ``1/sqrt(fan_in)``, ``fan_in`` the ``in`` dimension of the ``(in,
    out)`` layout, second to last: d for an expert's ``w_gate`` / ``w_up``
    ``(E, d, f)``, f for its ``w_down`` ``(E, f, d)``), 0.02-normal
    embeddings, zero norm scales.

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
            elif p.dim() >= 2:
                p.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
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


def _stack(layers: Sequence[dict]) -> dict:
    """Per-layer pytrees (dicts of arrays or of lists of arrays) stacked
    leaf by leaf along a new leading axis, as the reference stacks them."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in layers]) for k in first}
    if isinstance(first, list):
        return [_stack([p[i] for p in layers]) for i in range(len(first))]
    return np.stack(layers)


def gnn_params(cfg, seed: int = 0) -> dict:
    """Seeded float32 numpy weights for a GNN config, in the reference's
    layout (layer leaves stacked on a leading axis), with the reference's
    initializers: LeCun-normal matrices, He-normal MLPs, zero biases, unit
    norm scales.  The draw repeats on every host but differs from the
    reference's ``jax.random`` draw."""
    rng = np.random.default_rng(seed)
    if isinstance(cfg, GCNConfig):
        return gcn_params(layer_dims(cfg), seed)
    if isinstance(cfg, GatedGCNConfig):
        d = cfg.d_hidden
        p = {"embed_h": dense_init(rng, (cfg.d_in, d)),
             "embed_e": dense_init(rng, (cfg.d_edge_in, d)),
             "out": dense_init(rng, (d, cfg.n_classes))}
        p["layers"] = _stack([
            {**{k: dense_init(rng, (d, d)) for k in "ABCDE"},
             "ln_h_s": np.ones((d,), np.float32),
             "ln_h_b": np.zeros((d,), np.float32),
             "ln_e_s": np.ones((d,), np.float32),
             "ln_e_b": np.zeros((d,), np.float32)}
            for _ in range(cfg.n_layers)])
        return p
    if isinstance(cfg, MeshGraphNetConfig):
        d = cfg.d_hidden
        p = {"node_enc": mlp_init(rng, mlp_dims(cfg, cfg.d_in),
                                  layer_norm_out=True),
             "edge_enc": mlp_init(rng, mlp_dims(cfg, cfg.d_edge_in),
                                  layer_norm_out=True),
             "decoder": mlp_init(rng, [d] * cfg.mlp_layers + [cfg.d_out])}
        p["processors"] = _stack([
            {"edge_mlp": mlp_init(rng, mlp_dims(cfg, 3 * d),
                                  layer_norm_out=True),
             "node_mlp": mlp_init(rng, mlp_dims(cfg, 2 * d),
                                  layer_norm_out=True)}
            for _ in range(cfg.n_layers)])
        return p
    if isinstance(cfg, EquiformerV2Config):
        C, lm = cfg.d_hidden, cfg.l_max

        def so2_layer() -> dict:
            n0 = (lm + 1) * C
            q = {"w_m0": dense_init(rng, (n0, n0), fan_in=n0)}
            for m in range(1, cfg.m_max + 1):
                nm = len(cfg.ls_for_m(m)) * C
                q[f"w_m{m}_r"] = dense_init(rng, (nm, nm), fan_in=nm)
                q[f"w_m{m}_i"] = dense_init(rng, (nm, nm), fan_in=nm)
            q["attn_mlp"] = mlp_init(rng, [2 * C, C, cfg.n_heads])
            q["gate"] = dense_init(rng, (C, lm * C), fan_in=C)
            q["ffn"] = mlp_init(rng, [C, 2 * C, C])
            q["norm_scale"] = np.ones((lm + 1, C), np.float32)
            return q

        return {"embed": dense_init(rng, (cfg.d_in, C)),
                "out_mlp": mlp_init(rng, [C, C, cfg.d_out]),
                "layers": _stack([so2_layer() for _ in range(cfg.n_layers)])}
    raise TypeError(f"not a GNN config: {type(cfg).__name__}")


def _layer(leaf, i: int):
    """Slice ``i`` of a stacked leaf (a list of stacked arrays: each's)."""
    if isinstance(leaf, (list, tuple)):
        return [np.asarray(a)[i] for a in leaf]
    return np.asarray(leaf)[i]


def _put_mlp(mlp, src: dict, what: str) -> None:
    """Copy a reference-layout MLP ``{"w": [...], "b": [...]}`` (and its
    LayerNorm's ``ln_scale`` / ``ln_bias``) into a :class:`~repro_torch.
    models.common.MLP`; layer counts and shapes must match."""
    for key in ("w", "b"):
        dsts = getattr(mlp, key)
        if len(src[key]) != len(dsts):
            raise ValueError(f"{what}[{key!r}]: {len(src[key])} layers, "
                             f"expected {len(dsts)}")
        for j, (dst, a) in enumerate(zip(dsts, src[key])):
            _put(dst, a, f"{what}[{key!r}][{j}]")
    if hasattr(mlp, "ln_scale") != ("ln_scale" in src):
        raise ValueError(f"{what}: LayerNorm weights do not match")
    if "ln_scale" in src:
        _put(mlp.ln_scale, src["ln_scale"], f"{what}['ln_scale']")
        _put(mlp.ln_bias, src["ln_bias"], f"{what}['ln_bias']")


def load_gcn(params_np: dict, cfg: GCNConfig, *, device=None) -> GCN:
    """The port's GCN holding ``params_np`` (``{"w": [...], "b": [...]}``)
    in f32 on ``device`` (CUDA by default); every shape must match."""
    model = GCN(cfg, device=device)
    with torch.no_grad():
        for key in ("w", "b"):
            if len(params_np[key]) != cfg.n_layers:
                raise ValueError(f"{len(params_np[key])} {key!r} layers for "
                                 f"{cfg.n_layers}")
            for i, (dst, src) in enumerate(zip(getattr(model, key),
                                               params_np[key])):
                _put(dst, src, f"{key}[{i}]")
    return model


def load_gatedgcn(params_np: dict, cfg: GatedGCNConfig, *,
                  device=None) -> GatedGCN:
    """The port's GatedGCN holding ``params_np`` (reference layout) in f32
    on ``device`` (CUDA by default); layer ``i`` takes slice ``i``."""
    model = GatedGCN(cfg, device=device)
    with torch.no_grad():
        for key in ("embed_h", "embed_e", "out"):
            _put(getattr(model, key), params_np[key], key)
        stacked = params_np["layers"]
        for i, layer in enumerate(model.layers):
            for key in GATEDGCN_KEYS:
                _put(getattr(layer, key), _layer(stacked[key], i),
                     f"layers[{key!r}][{i}]")
    return model


def load_meshgraphnet(params_np: dict, cfg: MeshGraphNetConfig, *,
                      device=None) -> MeshGraphNet:
    """The port's MeshGraphNet holding ``params_np`` (reference layout) in
    f32 on ``device`` (CUDA by default); processor ``i`` takes slice ``i``."""
    model = MeshGraphNet(cfg, device=device)
    with torch.no_grad():
        for key in ("node_enc", "edge_enc", "decoder"):
            _put_mlp(getattr(model, key), params_np[key], key)
        stacked = params_np["processors"]
        for i, proc in enumerate(model.processors):
            for key in ("edge_mlp", "node_mlp"):
                _put_mlp(getattr(proc, key),
                         {k: _layer(v, i) for k, v in stacked[key].items()},
                         f"processors[{key!r}][{i}]")
    return model


def load_equiformer_v2(params_np: dict, cfg: EquiformerV2Config, *,
                       device=None) -> EquiformerV2:
    """The port's EquiformerV2 holding ``params_np`` (reference layout) in
    f32 on ``device`` (CUDA by default); layer ``i`` takes slice ``i``."""
    model = EquiformerV2(cfg, device=device)
    with torch.no_grad():
        _put(model.embed, params_np["embed"], "embed")
        _put_mlp(model.out_mlp, params_np["out_mlp"], "out_mlp")
        stacked = params_np["layers"]
        matrices = ["w_m0", "gate", "norm_scale"] + [
            f"w_m{m}_{part}" for m in range(1, cfg.m_max + 1)
            for part in ("r", "i")]
        for i, layer in enumerate(model.layers):
            for key in matrices:
                _put(getattr(layer, key), _layer(stacked[key], i),
                     f"layers[{key!r}][{i}]")
            for key in ("attn_mlp", "ffn"):
                _put_mlp(getattr(layer, key),
                         {k: _layer(v, i) for k, v in stacked[key].items()},
                         f"layers[{key!r}][{i}]")
    return model


# ---------------------------------------------------------------------------
# The reverse direction: port modules as reference-layout trees (training)
# ---------------------------------------------------------------------------

#: Module containers whose layers the reference stacks on a leading axis.
_STACKED = ("layers", "processors")
_GNNS = (GCN, GatedGCN, MeshGraphNet, EquiformerV2)


def _location(model: nn.Module, name: str) -> tuple[tuple, Optional[int]]:
    """Where parameter ``name`` of ``model`` lives in the reference's tree:
    the path of its leaf and, for a stacked leaf, its slice (else None)."""
    parts = [int(p) if p.isdigit() else p for p in name.split(".")]
    if isinstance(model, Transformer):
        if parts[0] == "layers":
            g, i = divmod(parts[1], len(model.cfg.window_pattern))
            return ("blocks", i, *parts[2:]), g
    elif isinstance(model, DLRM):
        if parts[0] != "tables":   # bot_w.0 -> ("bot", "w", 0)
            return (*parts[0].split("_"), *parts[1:]), None
    elif isinstance(model, _GNNS):
        if parts[0] in _STACKED:
            return (parts[0], *parts[2:]), parts[1]
    else:
        raise TypeError(f"no reference layout for {type(model).__name__}")
    return tuple(parts), None


def _lists(node):
    """Dicts keyed 0..n-1 (list slots) turned into lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def gnn_tree(cfg, tree=None, *, seed: int = 0, device=None) -> dict:
    """A GNN's weights as a training tree of tensors on ``device`` (CUDA by
    default): ``tree`` (a reference-layout numpy tree, or tensors, which
    are moved there), or :func:`gnn_params` drawn from ``seed`` when it is
    None.  The draw is seeded numpy, so every rank that calls this with
    the same arguments holds the same tree: the replicated state of GNN
    training under a policy."""
    dev = resolve_device(device)
    if tree is None:
        tree = gnn_params(cfg, seed)
    if all(torch.is_tensor(t) for t in tree_leaves(tree)):
        return tree_map(lambda t: t.to(dev), tree)
    return tensor_tree(tree, device=dev)


def module_tree(model: nn.Module) -> dict:
    """A port module's weights as the reference's tree of tensors, on the
    module's device in its dtype: the module's own tensors (detached), and
    new stacks where the reference stacks layers."""
    leaves: dict[tuple, Any] = {}
    for name, p in model.named_parameters():
        path, layer = _location(model, name)
        if layer is None:
            leaves[path] = p.detach()
        else:
            leaves.setdefault(path, {})[layer] = p.detach()
    root: dict = {}
    for path, leaf in leaves.items():
        if isinstance(leaf, dict):
            leaf = torch.stack([leaf[i] for i in range(len(leaf))])
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(root)


def to_numpy(tree) -> Any:
    """Every tensor of a tree (a training state ``(params, opt_state)``
    among them) as a host numpy array, in the same structure; its leaves
    flatten in the reference's order."""
    return tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t)
                    else np.asarray(t), tree)


def tensor_tree(tree_np, *, device=None) -> Any:
    """A numpy tree (the reference's ``init_params`` output after
    ``np.asarray``, or a ``*_params`` draw) as tensors on ``device`` (CUDA
    by default), each leaf in its own dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree_np)


def _dump(model: nn.Module, kinds: tuple) -> dict:
    if not isinstance(model, kinds):
        raise TypeError(f"expected one of {[k.__name__ for k in kinds]}, "
                        f"got {type(model).__name__}")
    return tree_map(lambda t: t.float().cpu().numpy(), module_tree(model))


def dump_transformer(model: Transformer) -> dict:
    """The reverse of :func:`load_transformer`: the reference's f32 numpy
    tree (block ``i``'s slice ``g`` from layer ``g * P + i``)."""
    return _dump(model, (Transformer,))


def dump_dlrm(model: DLRM) -> dict:
    """The reverse of :func:`load_dlrm`: ``{"tables", "bot", "top"}``."""
    return _dump(model, (DLRM,))


def dump_gnn(model: nn.Module) -> dict:
    """The reverse of :func:`load_gcn`, :func:`load_gatedgcn`,
    :func:`load_meshgraphnet` and :func:`load_equiformer_v2`: layer ``i``
    becomes slice ``i`` of each stacked leaf."""
    return _dump(model, _GNNS)


def bind(model: nn.Module, tree) -> dict[str, torch.Tensor]:
    """``model``'s parameter names mapped to the tensors of a
    reference-layout ``tree``: the leaves themselves, or a stacked leaf's
    slices (one ``unbind`` per leaf, whose backward stacks the slices'
    gradients)."""
    unbound: dict[tuple, tuple] = {}
    out = {}
    for name, _ in model.named_parameters():
        path, layer = _location(model, name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if layer is not None:
            if path not in unbound:
                unbound[path] = leaf.unbind(0)
            leaf = unbound[path][layer]
        out[name] = leaf
    return out


class _Apply(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def tree_loss(model: nn.Module, fn: Callable) -> Callable:
    """``fn(model, *args)`` as ``loss(tree, *args)``: evaluated with the
    module's weights read from a reference-layout tree
    (``torch.func.functional_call``), so gradients flow to the tree.  The
    module only lends its structure; its own weights are not read, in the
    backward pass either: the GNN layers' recompute
    (``models.common.checkpoint_layer``) binds the tree's tensors it took
    in the forward, after this call has restored the module's own."""
    wrapper = _Apply(model, fn)

    def loss(tree, *args):
        weights = {f"model.{k}": v for k, v in bind(model, tree).items()}
        return torch.func.functional_call(wrapper, weights, args)

    return loss


# ---------------------------------------------------------------------------
# One rank's slices of a sharded model
# ---------------------------------------------------------------------------

def _cut(src, spec: tuple, policy, *, device, dtype) -> torch.Tensor:
    """This rank's block of ``src`` (a numpy array or a tensor) by
    ``spec``, on ``device`` in ``dtype``: a view where ``src`` is already
    there in that dtype."""
    block = src[shard_slices(src.shape, spec, policy)]
    if isinstance(block, np.ndarray):
        # A copy: a step that updates the block in place must not write
        # into the caller's array.
        return torch.from_numpy(np.array(block, np.float32)).to(
            device=device, dtype=dtype)
    return block.to(device=device, dtype=dtype)


def _shard_seed(seed: int, leaf: int, coord: int) -> int:
    """The generator seed of leaf ``leaf``'s block at ``coord``."""
    return (1_000_003 * seed + leaf) * 1_000_033 + coord


def _draw_block(shape: tuple, spec: tuple, path: tuple, leaf: int, policy,
                *, seed: int, device, dtype) -> torch.Tensor:
    """This rank's block of a leaf of global ``shape`` by ``spec``, drawn
    in place with the reference's initializers (zero norm scales,
    0.02-normal embedding, LeCun-normal matrices: std ``1/sqrt(shape[-2])``)
    from a generator seeded with ``seed``, ``leaf`` and the rank's index
    along the spec's axes."""
    local = tuple(t.stop - t.start if t.stop is not None else n
                  for t, n in zip(shard_slices(shape, spec, policy), shape))
    out = torch.empty(local, dtype=dtype, device=device)
    name = path[-1]
    with torch.no_grad():
        if name in ("ln1", "ln2", "final_norm"):
            return out.zero_()
        coord = policy.coord(spec_axes(spec, policy))
        gen = torch.Generator(device=device).manual_seed(
            _shard_seed(seed, leaf, coord))
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        return out.normal_(0.0, std, generator=gen)


def shard_transformer_tree(source, cfg: TransformerConfig, policy, *,
                           specs: Optional[dict] = None, device=None,
                           dtype: Optional[torch.dtype] = None,
                           seed: int = 0) -> dict:
    """This rank's blocks of a transformer in the reference's tree layout
    (the training state), laid out by ``specs`` (default
    ``transformer.param_pspecs``; training passes
    ``transformer.train_pspecs``), in ``dtype`` (default f32) on
    ``device`` (CUDA by default).

    ``source`` is a reference-layout numpy tree (:func:`transformer_params`
    or the reference's ``init_params`` after ``np.asarray``), cut block by
    block, or None to draw each block in place (:func:`_draw_block`): leaf
    ``i`` of the flatten order from a generator seeded with ``seed``, ``i``
    and the rank's index along the leaf's own spec axes (FSDP axes
    included), so a model larger than one card never exists whole, a
    replicated leaf is the same on every rank and a block is the same
    wherever it is drawn."""
    from .models.transformer import _param_shapes

    dev = resolve_device(device)
    dtype = dtype or torch.float32
    specs = specs or transformer_pspecs(cfg, policy)
    laid = dict(tree_paths(specs, is_spec))
    src = dict(tree_paths(source)) if source is not None else None
    shapes = _param_shapes(cfg)
    blocks = []
    for leaf, (path, shape) in enumerate(tree_paths(shapes, is_spec)):
        if src is not None:
            blocks.append(_cut(np.asarray(src[path]), laid[path], policy,
                               device=dev, dtype=dtype))
        else:
            blocks.append(_draw_block(tuple(shape), laid[path], path, leaf,
                                      policy, seed=seed, device=dev,
                                      dtype=dtype))
    return tree_unflatten(tree_flatten(shapes, is_spec)[1], blocks)


def shard_transformer(source, cfg: TransformerConfig, policy, *,
                      device=None, dtype: Optional[torch.dtype] = None,
                      seed: int = 0) -> ShardedTransformer:
    """This rank's :class:`ShardedTransformer`: ``source``, a
    reference-layout numpy tree (:func:`transformer_params`, or the
    reference's ``init_params`` after ``np.asarray``) or a
    :class:`Transformer`, cut by ``transformer.param_pspecs(cfg, policy)``,
    or None to draw the rank's blocks in place
    (:func:`shard_transformer_tree`, from ``seed``); in ``dtype`` (by
    default the module's, or the config's compute dtype) on ``device``
    (CUDA by default).  From a module already on the device in that dtype,
    the slices are views."""
    dev = resolve_device(device)
    module = isinstance(source, Transformer)
    dtype = dtype or (source.embed.dtype if module else cfg.compute_dtype)
    specs = transformer_pspecs(cfg, policy)
    P = len(cfg.window_pattern)
    kw = {"device": dev, "dtype": dtype}
    if source is None:
        # The drawn blocks are the rank's already: cut nothing further.
        tree = shard_transformer_tree(None, cfg, policy, seed=seed, **kw)
        full = tree_map(lambda spec: (None,) * len(spec), specs,
                        is_leaf=is_spec)
        return _sharded_from_tree(tree, full, cfg, policy, kw)

    if not module:
        return _sharded_from_tree(source, specs, cfg, policy, kw)

    def top(name: str) -> torch.Tensor:
        return _cut(getattr(source, name).detach(), specs[name], policy,
                    **kw)

    layers = []
    for n in range(cfg.n_layers):
        g, i = divmod(n, P)
        spec = specs["blocks"][i]
        mod = source.layers[n]
        layer = SimpleNamespace(
            window=cfg.window_pattern[i],
            **{key: _cut(getattr(mod, key).detach(), spec[key][1:], policy,
                         **kw) for key in layer_keys(cfg)})
        if cfg.moe is not None:
            layer.moe = {key: _cut(mod.moe[key].detach(),
                                   spec["moe"][key][1:], policy, **kw)
                         for key in MOE_KEYS}
        layers.append(layer)
    return ShardedTransformer(
        cfg, policy, top("embed"), top("final_norm"), layers,
        None if cfg.tie_embeddings else top("unembed"))


def _sharded_from_tree(tree, specs, cfg: TransformerConfig, policy,
                       kw: dict) -> ShardedTransformer:
    """A :class:`ShardedTransformer` from a reference-layout tree (numpy
    or tensors), each leaf cut by ``specs``."""
    P = len(cfg.window_pattern)

    def cut(src, spec):
        return _cut(src if torch.is_tensor(src) else np.asarray(src), spec,
                    policy, **kw)

    layers = []
    for n in range(cfg.n_layers):
        g, i = divmod(n, P)
        spec, blk = specs["blocks"][i], tree["blocks"][i]
        layer = SimpleNamespace(
            window=cfg.window_pattern[i],
            **{key: cut(blk[key][g], spec[key][1:])
               for key in layer_keys(cfg)})
        if cfg.moe is not None:
            layer.moe = {key: cut(blk["moe"][key][g], spec["moe"][key][1:])
                         for key in MOE_KEYS}
        layers.append(layer)
    return ShardedTransformer(
        cfg, policy, cut(tree["embed"], specs["embed"]),
        cut(tree["final_norm"], specs["final_norm"]), layers,
        None if cfg.tie_embeddings else cut(tree["unembed"],
                                            specs["unembed"]))


def shard_dlrm(source, cfg: DLRMConfig, policy, *, device=None,
               seed: int = 0) -> ShardedDLRM:
    """This rank's :class:`ShardedDLRM`, f32 on ``device`` (CUDA by
    default): each table's shard by ``dlrm.param_pspecs(cfg, policy)``,
    with a zero row appended where the table is sharded, and the MLPs.

    ``source`` is a reference-layout numpy tree (:func:`dlrm_params`, or the
    reference's ``init_params`` after ``np.asarray``), or None to draw in
    place on the device: table ``t``'s shard 0.02-normal from a generator
    seeded with ``seed``, ``t`` and the rank's index along the axes that
    shard the table (0 for a replicated table), so a shard is the same on
    every rank that holds it; the MLPs He-normal (zero biases) from one
    seeded with ``seed``, the same on every rank."""
    dev = resolve_device(device)
    specs = dlrm_pspecs(cfg, policy)
    d = cfg.embed_dim
    tables = []
    for t, (v, spec) in enumerate(zip(cfg.vocab_sizes, specs["tables"])):
        pad = spec[0] is not None
        if source is not None:
            table = _cut(np.asarray(source["tables"][t]), spec, policy,
                         device=dev, dtype=torch.float32)
            if pad:
                table = torch.cat([table, table.new_zeros(1, d)])
        else:
            rows = v // policy.size(spec[0]) if pad else v
            shard = policy.coord(spec[0]) if pad else 0
            gen = torch.Generator(device=dev).manual_seed(
                _shard_seed(seed, t, shard))
            table = torch.empty((rows + pad, d), dtype=torch.float32,
                                device=dev)
            with torch.no_grad():
                table[:rows].normal_(0.0, 0.02, generator=gen)
                table[rows:].zero_()
        tables.append(table)
    if source is not None:
        mlps = {name: {key: [torch.tensor(np.asarray(a, np.float32),
                                          device=dev)
                             for a in source[name][key]]
                       for key in ("w", "b")} for name in ("bot", "top")}
    else:
        mgen = torch.Generator(device=dev).manual_seed(seed)
        mlps = {}
        for name, dims in (("bot", (cfg.n_dense,) + cfg.bot_mlp),
                           ("top", (cfg.interaction_dim(),) + cfg.top_mlp)):
            ws = [torch.empty((a, b), device=dev).normal_(
                0.0, (2.0 / a) ** 0.5, generator=mgen)
                for a, b in zip(dims[:-1], dims[1:])]
            mlps[name] = {"w": ws, "b": [torch.zeros(b, device=dev)
                                         for b in dims[1:]]}
    return ShardedDLRM(cfg, policy, tables, mlps["bot"], mlps["top"])
