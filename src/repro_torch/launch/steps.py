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
* :func:`gnn_train_cell` (``_gnn_plan``): the four GNNs, AdamW at 1e-3,
  on one device or under a policy: the state replicated on every rank,
  each rank training on its :class:`~repro_torch.models.gnn.graph.
  GraphShard` of the batch, laid out by :func:`gnn_graph_specs` (nodes
  and edges over every axis for GCN and GatedGCN, over the dp axes for
  MeshGraphNet and EquiformerV2, whose ``model`` ranks compute alike), and the
  gradients summed over every rank; the ``minibatch_lg`` cell trains on a
  sampled subgraph padded to :func:`sampled_subgraph_sizes`, which
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
from ..core import comm_model
from ..data.sampler import SampledSubgraph
from ..distributed import comm
from ..models import dlrm as dlrm_lib
from ..models import transformer as tf_lib
from ..models.gnn.gcn import layer_dims
from ..models.gnn.graph import GraphBatch, GraphShard, shard_graph
from ..optim.optimizers import AdamWState, adamw, global_norm, make_step
from ..params import (gnn_tree, shard_dlrm, shard_transformer_tree,
                      tree_loss)
from ..tree import tree_leaves, tree_map
from .train import GNN_MODELS

__all__ = ["PAD_TO", "GNN_N_CLASSES", "sampled_subgraph_sizes",
           "lm_train_dtype", "TrainCell", "lm_train_cell",
           "dlrm_train_cell", "gnn_train_cell", "gnn_config",
           "gnn_graph_specs", "gnn_node_split", "gnn_policy_traffic",
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


#: The wide models: nodes and edges over the dp axes (the reference also
#: lays their hidden channels over ``model``; here they stay whole).
_TWO_D = ("meshgraphnet", "equiformer-v2")


def gnn_graph_specs(arch_name: str, g: GraphBatch, policy) -> GraphBatch:
    """The reference's ``_gnn_graph_specs``: each field of ``g`` with the
    axes its first dim splits over, as a ``GraphBatch`` of specs.  Nodes
    and edges split over the dp axes for MeshGraphNet and EquiformerV2
    (their hidden channels whole on every ``model`` rank), over every
    axis for GCN and GatedGCN; node-level labels as the nodes, graph-level
    labels whole."""
    axes, _ = gnn_node_split(arch_name, policy)
    node = (axes,)
    kw: dict[str, Any] = dict(
        node_feat=(axes, None), senders=node, receivers=node,
        node_mask=node, edge_mask=node, n_graphs=g.n_graphs)
    if g.graph_ids is not None:
        kw["graph_ids"] = node
    if g.edge_feat is not None:
        kw["edge_feat"] = (axes, None)
    if g.wigner is not None:
        kw["wigner"] = {l: ((None, axes, None, None) if w.ndim == 4
                            else (axes, None, None))
                        for l, w in g.wigner.items()}
    if g.positions is not None:
        kw["positions"] = (axes, None)
    lbl = g.labels
    if lbl.shape[0] == g.node_feat.shape[0]:
        kw["labels"] = node if lbl.ndim == 1 else (axes, None)
    else:
        kw["labels"] = () if lbl.ndim == 1 else (None,) * lbl.ndim
    return GraphBatch(**kw)


def gnn_node_split(arch_name: str, policy) -> tuple[Any, int]:
    """(The node axes, the node ranks) of ``arch_name`` under ``policy``."""
    axes = (policy.dp_spec if arch_name in _TWO_D
            else tuple(policy.dp_axes) + (policy.tp_axis,))
    return axes, policy.size(axes)


def gnn_policy_traffic(arch_name: str, cfg, policy, n_total: int,
                       param_bytes: int) -> dict:
    """The wire bytes a rank of one GNN train step under ``policy``, by
    ``(tag, kind)``, from the paper's models: each senders' all-gather of
    ``n_total`` padded node rows over the node ranks is
    ``spmm_feature_allgather(n_total, width, node ranks)`` (GCN
    ``d_hidden`` then ``n_classes`` wide, GatedGCN and MeshGraphNet
    ``d_hidden`` a layer, EquiformerV2 ``L2 * d_hidden`` a layer), its
    backward's reduce-scatter the same, and the gradient sum
    ``dp_gradient_sync(param_bytes, n_devices)``.  The readout's psums
    (``gnn_readout``, a few scalars) are not modelled."""
    _, n = gnn_node_split(arch_name, policy)
    if arch_name == "gcn-cora":
        widths = layer_dims(cfg)[1:]
    elif arch_name == "equiformer-v2":
        widths = [cfg.L2 * cfg.d_hidden] * cfg.n_layers
    else:
        widths = [cfg.d_hidden] * cfg.n_layers
    gather = sum(comm_model.spmm_feature_allgather(n_total, w, n).total(
        "ici") for w in widths)
    return {("gnn_gather", "all-gather"): gather,
            ("gnn_gather", "reduce-scatter"): gather,
            ("grad_dp", "all-reduce"): comm_model.dp_gradient_sync(
                param_bytes, policy.n_devices).total("ici")}


def _gnn_sizes(shape: ShapeSpec) -> tuple[int, int]:
    """The padded (nodes, edges) of a GNN shape, as
    ``_gnn_graph_abstract`` pads them."""
    p = shape.params
    if shape.kind == "train_sampled":
        return sampled_subgraph_sizes(p["batch_nodes"], tuple(p["fanout"]))
    return (_pad(p["n_nodes"] * p.get("batch", 1)),
            _pad(p["n_edges"] * p.get("batch", 1)))


def _shard_gnn_batch(arch_name: str, cfg, policy, dev,
                     g: GraphBatch) -> GraphShard:
    """This rank's shard of a global batch (numpy or tensors), on ``dev``:
    nodes padded to :data:`PAD_TO`."""
    g = g.to(dev)
    return shard_graph(g, gnn_graph_specs(arch_name, g, policy), policy,
                       n_total=_pad(g.n_nodes))


def _sync_replicated(policy, grads) -> torch.Tensor:
    """Each leaf's gradient summed over every rank in place (tagged
    ``"grad_dp"``), and the global norm of the sum, alike on every rank."""
    if policy.n_devices > 1:
        comm.all_reduce_grads(tree_leaves(grads),
                              policy.group(policy.all_axes), tag="grad_dp")
    return global_norm(grads)


def gnn_train_cell(arch, shape, policy, params=None, *, cfg=None,
                   seed: int = 0, device=None) -> TrainCell:
    """The reference's ``_gnn_plan`` train step over real state: ``params``
    a reference-layout tree (numpy or tensors; None draws
    ``params.gnn_params(cfg, seed)``), AdamW at 1e-3 (clipping at norm 1),
    the model's ``loss_fn`` over the batch.

    With ``policy`` None the step runs on one device.  Under a policy (of
    any size, one rank included) the parameters and moments are replicated
    on every rank (``specs`` and ``opt_specs`` say so: empty specs), each
    rank trains on its :class:`GraphShard` of the global batch every rank
    passes alike (``meta["shard"]`` cuts one; the step cuts a
    ``GraphBatch`` itself), its loss is its share of the global loss, and
    each leaf's gradient is summed over every rank before AdamW clips by
    the global norm.  It raises, naming the reason, for EquiformerV2's
    edge chunks (``edge_chunks`` > 1) and for padded sizes of ``shape``
    that do not split over the node ranks; nothing falls back to the
    single-device step."""
    arch, shape = _arch_shape(arch, shape)
    cfg = cfg or gnn_config(arch, shape)
    if policy is not None:
        axes, n = gnn_node_split(arch.name, policy)
        n_pad, _ = _gnn_sizes(shape)
        if n_pad % n:
            raise ValueError(
                f"{arch.name} x {shape.name}: {n_pad} padded nodes do not "
                f"split over {n} node ranks ({axes})")
        if getattr(cfg, "edge_chunks", 1) > 1:
            raise ValueError(
                f"{arch.name} x {shape.name}: {cfg.edge_chunks} edge chunks "
                "under a policy (the chunked eSCN convolution has no "
                "sharded layout)")
    dev = resolve_device(device)
    params = gnn_tree(cfg, params, seed=seed, device=dev)
    module, model_cls = GNN_MODELS[arch.name]
    optimizer = adamw(1e-3, donate=True)
    loss = tree_loss(model_cls(cfg, device=dev), module.loss_fn)
    meta: dict[str, Any] = {"optimizer": optimizer}
    if shape.kind == "train_sampled":
        meta["sizes"] = _gnn_sizes(shape)
    if policy is None:
        return TrainCell(arch.name, shape.name,
                         _wrap(make_step(loss, optimizer)), params,
                         optimizer.init(params), None, None, cfg, meta=meta)
    shard = partial(_shard_gnn_batch, arch.name, cfg, policy, dev)
    step_fn = make_step(loss, optimizer,
                        sync=partial(_sync_replicated, policy))

    def train_step(params, opt_state, batch):
        if not isinstance(batch, GraphShard):
            batch = shard(batch)
        (params, opt_state), metrics = step_fn((params, opt_state), batch)
        return params, opt_state, metrics

    specs = tree_map(lambda _: (), params)
    meta["shard"] = shard
    return TrainCell(arch.name, shape.name, train_step, params,
                     optimizer.init(params), specs, _opt_state_specs(specs),
                     cfg, meta=meta)


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
