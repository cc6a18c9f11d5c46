"""Train cells: (arch x shape x policy) -> a train step over real state
(the train half of the reference's ``launch/steps.py``).

Each builder takes an architecture, a shape, a
:class:`repro_torch.distributed.sharding.ShardingPolicy` and this rank's
state (or draws it), and returns a :class:`TrainCell` whose ``step`` is the
reference's ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``:

* :func:`lm_train_cell` (the reference's ``_lm_plan`` train branch): the
  state laid out by ``transformer.train_pspecs`` (FSDP over the dp axes),
  AdamW at 3e-4 with weight decay 0.1, its moments in the parameters'
  layout (:func:`_opt_state_specs`), and the storage rule: bf16 parameters
  and moments once the f32 triple passes 9e9 bytes a device
  (:func:`lm_train_dtype`);
* :func:`dlrm_train_cell` (``_dlrm_plan``): the tables vocab-parallel
  (``dlrm.param_pspecs``, K6 on every shard), the MLPs data-parallel over
  every rank, AdamW at 1e-3;
* :func:`gnn_train_cell` (``_gnn_plan``): the four GNNs at world size 1
  only, AdamW at 1e-3; the ``minibatch_lg`` cell trains on a sampled
  subgraph padded to :func:`sampled_subgraph_sizes`, which
  :func:`subgraph_batch` lays out as the reference's graph batch.

Every rank passes the same global batch.  A cell that cannot run under its
policy raises; nothing falls back to a single-device step.  ``build_cell``,
``CellPlan``, the abstract shapes and the FLOP counts (the dry run) are
not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..backend import resolve_device
from ..configs import get_arch
from ..configs.base import ArchDef, ShapeSpec
from ..data.sampler import SampledSubgraph
from ..models import dlrm as dlrm_lib
from ..models import transformer as tf_lib
from ..models.gnn.graph import GraphBatch
from ..optim.optimizers import AdamWState, adamw, make_step
from ..params import (gnn_params, shard_dlrm, shard_transformer_tree,
                      tensor_tree, tree_loss)
from ..tree import tree_leaves
from .train import GNN_MODELS

__all__ = ["PAD_TO", "GNN_N_CLASSES", "sampled_subgraph_sizes",
           "lm_train_dtype", "TrainCell", "lm_train_cell",
           "dlrm_train_cell", "gnn_train_cell", "gnn_config",
           "subgraph_batch"]

PAD_TO = 512  # graph dims padded to multiples of this (divides both meshes)

# Node-classification label cardinality per GNN shape (Cora / Reddit / OGBN-
# products; molecule is graph-level).
GNN_N_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
                 "molecule": 10}

#: Bytes a device may hold of f32 parameters and two f32 moments before
#: the LM cells store all three in bf16 (the reference's rule).
F32_TRAIN_BYTES_LIMIT = 9e9


def _pad(n: int, to: int = PAD_TO) -> int:
    return ((n + to - 1) // to) * to


def sampled_subgraph_sizes(batch_nodes: int,
                           fanout: tuple[int, ...]) -> tuple[int, int]:
    """Padded (nodes, edges) of a fanout-sampled k-hop subgraph."""
    nodes, edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return _pad(nodes), _pad(edges)


def _opt_state_specs(param_specs):
    """AdamW's state in the parameters' layout: the step replicated, each
    moment as its parameter."""
    return AdamWState(step=(), mu=param_specs, nu=param_specs)


def lm_train_dtype(cfg: tf_lib.TransformerConfig, policy) -> torch.dtype:
    """The reference's storage rule: f32 parameters and moments unless the
    f32 triple (12 bytes a parameter) passes 9e9 bytes a device, then
    bf16."""
    f32_train_bytes = 12.0 * cfg.param_count() / policy.n_devices
    return (torch.bfloat16 if f32_train_bytes > F32_TRAIN_BYTES_LIMIT
            else torch.float32)


@dataclass
class TrainCell:
    """One train cell on this rank: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` and the state it starts from
    (``params``, ``opt_state``), laid out by ``specs`` (``opt_specs`` for
    the optimizer's state)."""

    arch: str
    shape: str
    step: Callable
    params: Any
    opt_state: Any
    specs: Any
    opt_specs: Any
    cfg: Any
    meta: dict = field(default_factory=dict)


def _arch_shape(arch, shape) -> tuple[ArchDef, ShapeSpec]:
    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = arch.shapes[shape] if isinstance(shape, str) else shape
    if shape.kind not in ("train", "train_sampled"):
        raise ValueError(f"{arch.name} x {shape.name}: a {shape.kind} cell, "
                         "not a train cell")
    return arch, shape


def _wrap(step_fn: Callable) -> Callable:
    def train_step(params, opt_state, batch):
        (params, opt_state), metrics = step_fn((params, opt_state), batch)
        return params, opt_state, metrics
    return train_step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def lm_train_cell(arch, shape, policy, params=None, *, cfg=None,
                  seed: int = 0, device=None,
                  min_bytes: int = 1 << 20) -> TrainCell:
    """The reference's ``_lm_plan`` train branch over real state.
    ``params`` is this rank's blocks of a reference-layout tree laid out by
    ``transformer.train_pspecs`` (a numpy tree is cut to them), or None to
    draw them in place (``params.shard_transformer_tree``, from
    ``seed``); in the storage dtype of :func:`lm_train_dtype`.  ``cfg``
    replaces the architecture's published config (a smoke config);
    ``min_bytes`` is FSDP's threshold.  The global batch is
    ``meta["batch"]`` x ``meta["seq"]``."""
    arch, shape = _arch_shape(arch, shape)
    cfg = cfg or arch.make_config()
    dtype = lm_train_dtype(cfg, policy)
    specs = tf_lib.train_pspecs(cfg, policy, dtype=dtype,
                                min_bytes=min_bytes)
    dev = resolve_device(device)
    if params is None or not all(torch.is_tensor(t) for t in
                                 tree_leaves(params)):
        params = shard_transformer_tree(params, cfg, policy, specs=specs,
                                        device=dev, dtype=dtype, seed=seed)
    big = dtype == torch.bfloat16
    optimizer = adamw(3e-4, weight_decay=0.1,
                      state_dtype=torch.bfloat16 if big else torch.float32,
                      donate=not big)
    step = tf_lib.make_train_step(cfg, optimizer, policy=policy,
                                  specs=specs)
    return TrainCell(arch.name, shape.name, step, params,
                     optimizer.init(params), specs, _opt_state_specs(specs),
                     cfg, meta={"batch": shape.params["batch"],
                                "seq": shape.params["seq"], "dtype": dtype,
                                "optimizer": optimizer})


# ---------------------------------------------------------------------------
# DLRM cells
# ---------------------------------------------------------------------------

def dlrm_train_cell(arch, shape, policy, params=None, *, cfg=None,
                    seed: int = 0, device=None) -> TrainCell:
    """The reference's ``_dlrm_plan`` train branch over real state:
    ``params`` is this rank's ``ShardedDLRM`` (or a reference-layout numpy
    tree to cut, or None to draw, ``params.shard_dlrm``), trained as its
    tree ``{"tables", "bot", "top"}`` (zero rows included) by AdamW at 1e-3
    with ``dlrm.loss_fn(policy=)`` and ``dlrm.sync_grads``."""
    arch, shape = _arch_shape(arch, shape)
    cfg = cfg or arch.make_config()
    if not isinstance(params, dlrm_lib.ShardedDLRM):
        params = shard_dlrm(params, cfg, policy, device=device, seed=seed)
    optimizer = adamw(1e-3, donate=True)

    def loss(tree, batch):
        return dlrm_lib.loss_fn(
            dlrm_lib.ShardedDLRM.from_tree(cfg, policy, tree), batch,
            policy=policy)

    step_fn = make_step(loss, optimizer,
                        sync=partial(dlrm_lib.sync_grads, cfg, policy))
    specs = dlrm_lib.param_pspecs(cfg, policy)
    tree = params.tree()
    return TrainCell(arch.name, shape.name, _wrap(step_fn), tree,
                     optimizer.init(tree), specs, _opt_state_specs(specs),
                     cfg, meta={"batch": shape.params["batch"],
                                "optimizer": optimizer})


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def gnn_config(arch, shape):
    """The published config sized for ``shape``, as ``_gnn_plan`` makes it:
    the shape's feature width, its class count (GCN, GatedGCN), the graph
    readout on ``molecule``, and 64 edge chunks for EquiformerV2 past a
    million edges."""
    arch, shape = _arch_shape(arch, shape)
    p = dict(shape.params)
    mk: dict[str, Any] = {"d_in": p["d_feat"]}
    if arch.name in ("gcn-cora", "gatedgcn"):
        mk["n_classes"] = GNN_N_CLASSES[shape.name]
        if shape.name == "molecule":
            mk["readout"] = "graphs"
    if arch.name == "equiformer-v2":
        n_e = (sampled_subgraph_sizes(p["batch_nodes"], tuple(p["fanout"]))[1]
               if shape.kind == "train_sampled"
               else _pad(p["n_edges"] * p.get("batch", 1)))
        if n_e >= 1_000_000:
            mk["edge_chunks"] = 64
    return arch.make_config(**mk)


def gnn_train_cell(arch, shape, policy, params=None, *, cfg=None,
                   seed: int = 0, device=None) -> TrainCell:
    """The reference's ``_gnn_plan`` train step over real state at world
    size 1: ``params`` a reference-layout tree (numpy or tensors; None
    draws ``params.gnn_params(cfg, seed)``), AdamW at 1e-3, the model's
    ``loss_fn`` over the batch.  Under a policy of more than one device it
    raises: GNN training sharded over nodes and edges is ROADMAP item
    10c."""
    arch, shape = _arch_shape(arch, shape)
    if policy is not None and policy.n_devices > 1:
        raise ValueError(
            f"{arch.name} x {shape.name}: GNN training under a policy of "
            f"{policy.n_devices} devices (nodes and edges over every axis) "
            "is not ported (ROADMAP item 10c)")
    cfg = cfg or gnn_config(arch, shape)
    dev = resolve_device(device)
    if params is None:
        params = gnn_params(cfg, seed)
    if not all(torch.is_tensor(t) for t in tree_leaves(params)):
        params = tensor_tree(params, device=dev)
    module, model_cls = GNN_MODELS[arch.name]
    optimizer = adamw(1e-3, donate=True)
    step_fn = make_step(tree_loss(model_cls(cfg, device=dev),
                                  module.loss_fn), optimizer)
    meta = {"optimizer": optimizer}
    if shape.kind == "train_sampled":
        meta["sizes"] = sampled_subgraph_sizes(
            shape.params["batch_nodes"], tuple(shape.params["fanout"]))
    return TrainCell(arch.name, shape.name, _wrap(step_fn), params,
                     optimizer.init(params), None, None, cfg, meta=meta)


def subgraph_batch(arch_name: str, cfg, sub: SampledSubgraph,
                   node_feat: np.ndarray, labels: np.ndarray, *,
                   positions: Optional[np.ndarray] = None) -> GraphBatch:
    """A sampled subgraph of a graph with ``node_feat`` (V, F) and
    ``labels`` as the reference's graph batch for ``arch_name``
    (``_gnn_graph_abstract``), at the subgraph's padded shapes (numpy
    fields; ``.to(device)`` moves them).

    ``node_feat`` are gathered at the subgraph's global ids, zero on the
    padding; the edges are the local ids with ``edge_mask``.  The
    node-level losses (GCN and GatedGCN classes from ``labels`` (V,),
    MeshGraphNet targets from ``labels`` (V, d_out)) count the seeds only:
    ``node_mask`` is the seed mask.  EquiformerV2 reads out the real nodes
    (``node_mask`` the node mask) against the graph-level ``labels`` (1,
    d_out), with ``positions`` (V, 3) gathered and each real edge's Wigner
    blocks from its sender-to-receiver vector (the identity on padding)."""
    nmask, emask = sub.node_mask, sub.edge_mask
    kw: dict[str, Any] = dict(
        node_feat=np.asarray(node_feat)[sub.node_ids] * nmask[:, None],
        senders=sub.senders, receivers=sub.receivers,
        node_mask=sub.seed_mask, edge_mask=emask)
    if arch_name in ("gcn-cora", "gatedgcn"):
        kw["labels"] = np.asarray(labels)[sub.node_ids].astype(np.int32)
    if arch_name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = np.repeat(emask[:, None], cfg.d_edge_in, axis=1)
    if arch_name == "meshgraphnet":
        kw["labels"] = (np.asarray(labels)[sub.node_ids]
                        * sub.seed_mask[:, None]).astype(np.float32)
    elif arch_name == "equiformer-v2":
        from ..data.wigner import rotation_to_z, wigner_stack
        if positions is None:
            raise ValueError("EquiformerV2 takes node positions")
        pos = np.asarray(positions, np.float64)[sub.node_ids]
        vecs = pos[sub.senders] - pos[sub.receivers]
        vecs[emask == 0] = 0.0
        wig = wigner_stack(np.stack([rotation_to_z(v) for v in vecs]),
                           cfg.l_max, m_max=cfg.m_max)
        kw["wigner"] = {l: w.astype(np.float32) for l, w in wig.items()}
        kw["positions"] = pos.astype(np.float32)
        kw["labels"] = np.asarray(labels, np.float32).reshape(1, cfg.d_out)
        kw["node_mask"] = nmask
    elif arch_name not in ("gcn-cora", "gatedgcn"):
        raise ValueError(f"no sampled batch for {arch_name!r}")
    return GraphBatch(**kw)
