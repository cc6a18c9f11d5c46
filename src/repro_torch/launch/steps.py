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
policy raises; nothing falls back to a single-device step.

The dry half (the reference's ``CellPlan`` and ``build_cell``):
:func:`build_cell` / :func:`plan` give a :class:`CellPlan` of any run cell
under a policy: the abstract arguments (``meta`` tensors of the global
shapes, as the reference's ``ShapeDtypeStruct`` objects), each argument's
layout, ``model_flops`` and ``meta`` as the reference counts them, and a
``step`` that builds this rank's step through the train cells above and
the ``policy=`` serving paths.  :meth:`CellPlan.trace` runs one rank's
step under ``FakeTensorMode`` for ``launch.dryrun``.  The prefill and
decode cells serve bf16 weights sharded over the dp axes too where a
tensor-parallel shard would pass :data:`SERVE_FSDP_BYTES` (arctic-480b),
gathered a layer at a time; the retrieval cell's top-k merges each rank's
(:func:`retrieval_step`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
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
from ..distributed.sharding import fsdp_specs, make_policy
from ..models import dlrm as dlrm_lib
from ..models import transformer as tf_lib
from ..models.gnn.gcn import layer_dims
from ..models.gnn.graph import GraphBatch, GraphShard, shard_graph
from ..optim.optimizers import AdamWState, adamw, global_norm, make_step
from ..params import (_sharded_from_tree, gnn_tree, shard_dlrm,
                      shard_transformer, shard_transformer_tree, tree_loss)
from ..tree import (is_spec, tree_flatten, tree_leaves, tree_map,
                    tree_unflatten)
from .train import GNN_MODELS

__all__ = ["PAD_TO", "GNN_N_CLASSES", "sampled_subgraph_sizes",
           "lm_train_dtype", "TrainCell", "lm_train_cell",
           "dlrm_train_cell", "gnn_train_cell", "gnn_config",
           "gnn_graph_specs", "gnn_node_split", "gnn_policy_traffic",
           "subgraph_batch", "SERVE_FSDP_BYTES", "CellPlan", "plan",
           "build_cell", "trace_device", "RETRIEVAL_TOP_K",
           "retrieval_step"]

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


# ---------------------------------------------------------------------------
# The dry run: (arch x shape x mesh) -> a plan that traces one rank's step
# ---------------------------------------------------------------------------

def trace_device() -> torch.device:
    """The device of a fake trace: ``cuda`` where the build has CUDA (a
    fake tensor needs the build's device, not a card), ``cpu`` otherwise.
    Both reach K5 and K6 through their ops."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def _local_shape(shape, spec: tuple, policy) -> tuple:
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= policy.size(entry)
    return tuple(out)


def _spec_pairs(args, specs) -> list:
    """``(tensor, spec)`` of every tensor leaf of ``args`` beside its spec
    in ``specs`` (dicts, lists, tuples, named tuples and graph batches)."""
    if torch.is_tensor(args):
        return [(args, specs)]
    if isinstance(args, GraphBatch):
        return [p for f in fields(GraphBatch)
                for p in _spec_pairs(getattr(args, f.name),
                                     getattr(specs, f.name))]
    if isinstance(args, dict):
        return [p for k in args for p in _spec_pairs(args[k], specs[k])]
    if isinstance(args, (list, tuple)):
        return [p for a, s in zip(args, specs) for p in _spec_pairs(a, s)]
    return []


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _blocks(tree, specs, policy, device):
    """This rank's empty blocks of a tree of meta tensors laid out by
    ``specs``, on ``device`` (fake under the dry run's mode)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        torch.empty(_local_shape(t.shape, s, policy), dtype=t.dtype,
                    device=device)
        for t, s in zip(leaves, tree_leaves(specs, is_spec))])


def _abstract_opt_state(params_abs, state_dtype=torch.float32) -> AdamWState:
    """AdamW's state as meta tensors: the step and two moments."""
    def moment():
        return tree_map(lambda t: _meta(t.shape, state_dtype), params_abs)
    return AdamWState(_meta((), torch.int32), moment(), moment())


@dataclass
class CellPlan:
    """One (arch x shape x mesh) cell: the reference's ``CellPlan``.

    ``args`` are ``meta`` tensors of the global shapes (the reference's
    ``ShapeDtypeStruct``s), ``specs`` each argument's layout over the mesh
    (the reference's ``in_shardings``), ``donate_argnums`` the arguments
    the step updates in place.  ``step(device, draw=False, seed=0)`` builds
    this rank's step function and its arguments on ``device`` through the
    train cells and the ``policy=`` paths: empty blocks (fake under
    :meth:`trace`), or with ``draw`` seeded values.  ``pad_bytes`` are the
    bytes a rank holds beyond its blocks of ``args`` (DLRM's zero row a
    table shard).  ``dtype`` names the compute dtype whose peak the
    roofline takes; ``notes`` say where the trace's layout departs from
    the port's run (the GNN cells' edges)."""

    arch: str
    shape: str
    kind: str
    step: Callable
    args: tuple
    specs: tuple
    model_flops: float
    policy: Any
    dtype: str = "bf16"
    donate_argnums: tuple = ()
    pad_bytes: int = 0
    meta: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)

    def state_bytes(self) -> int:
        """The bytes one rank holds of the arguments: each argument's block
        by its spec, and ``pad_bytes``."""
        total = self.pad_bytes
        for t, spec in _spec_pairs(self.args, self.specs):
            n = 1
            for d in _local_shape(t.shape, spec, self.policy):
                n *= d
            total += n * t.element_size()
        return total

    def trace(self, device=None) -> dict:
        """One rank's step run under ``FakeTensorMode`` on ``device``
        (default :func:`trace_device`), with ``FlopCounterMode``, a
        :class:`~repro_torch.launch.counters.StepCounter` and the
        collective ledger around it.  Returns ``flops`` (and ``k5_flops``,
        K5's share), ``op_bytes``, ``arg_bytes`` (the storages the step
        started from), ``peak_bytes`` and ``ledger``.  Needs a process
        group of the mesh's size (a ``fake`` one in the dry run)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode

        from .counters import StepCounter

        dev = torch.device(device) if device is not None else trace_device()
        counter = StepCounter()
        flops = FlopCounterMode(display=False)
        with FakeTensorMode(allow_non_fake_inputs=True):
            with counter:
                fn, args = self.step(dev)
            counter.hold(args)
            arg_bytes = counter.live
            counter.reset_peak()
            counter.op_bytes = 0
            with comm.recording() as ledger, counter, flops:
                out = fn(*args)
            del out
        k5 = torch.ops.repro_torch.flash_attention
        return {"flops": float(flops.get_total_flops()),
                "k5_flops": float(flops.get_flop_counts().get(
                    "Global", {}).get(k5, 0)),
                "op_bytes": float(counter.op_bytes),
                "arg_bytes": arg_bytes, "peak_bytes": counter.peak,
                "ledger": ledger}


# ---- LM cells --------------------------------------------------------------

#: Serving parameters also shard over the dp axes when a tensor-parallel
#: shard of the bf16 weights would pass this (the reference's rule).
SERVE_FSDP_BYTES = 8e9


def _lm_tokens(b: int, s: int, vocab: int, device, draw: bool, seed: int,
               ) -> dict:
    if not draw:
        z = lambda: torch.zeros((b, s), dtype=torch.int32,  # noqa: E731
                                device=device)
        return {"tokens": z(), "labels": z()}
    from ..data.synthetic import lm_batch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in lm_batch(seed, 0, batch=b, seq=s,
                                 vocab=vocab).items()}


class _GatheredLayers:
    """A :class:`ShardedTransformer`'s layers from FSDP blocks: layer
    ``n``'s tensor-parallel blocks all-gathered over dp (tagged
    ``"fsdp"``) when the loop reaches it, so one layer at a time is
    whole."""

    def __init__(self, cfg, policy, blocks: dict, specs: dict):
        self.cfg, self.blocks, self.specs = cfg, blocks, specs
        self.fsdp = tf_lib._Fsdp(policy, specs)

    def __len__(self) -> int:
        return self.cfg.n_layers

    def __iter__(self):
        from types import SimpleNamespace
        cfg, P = self.cfg, len(self.cfg.window_pattern)
        for n in range(cfg.n_layers):
            g, i = divmod(n, P)
            blk, spec = self.blocks["blocks"][i], self.specs["blocks"][i]
            layer = SimpleNamespace(window=cfg.window_pattern[i], **{
                key: self.fsdp.gather(blk[key][g], spec[key], stacked=True)
                for key in tf_lib.layer_keys(cfg)})
            if cfg.moe is not None:
                layer.moe = {key: self.fsdp.gather(
                    blk["moe"][key][g], spec["moe"][key], stacked=True)
                    for key in blk["moe"]}
            yield layer


def _serving_model(cfg, policy, blocks: dict, specs: dict, fsdp: bool):
    """The rank's :class:`ShardedTransformer` over its blocks of the
    reference-layout tree: views of them, or under FSDP the top-level
    leaves gathered and the layers gathered one at a time."""
    if not fsdp:
        full = tree_map(lambda s: (None,) * len(s), specs, is_leaf=is_spec)
        return _sharded_from_tree(blocks, full, cfg, policy, {
            "device": blocks["embed"].device, "dtype": blocks["embed"].dtype})
    gather = tf_lib._Fsdp(policy, specs).gather
    top = {k: gather(blocks[k], specs[k]) for k in blocks if k != "blocks"}
    return tf_lib.ShardedTransformer(
        cfg, policy, top["embed"], top["final_norm"],
        _GatheredLayers(cfg, policy, blocks, specs), top.get("unembed"))


def _lm_plan(arch: ArchDef, shape: ShapeSpec, policy, *,
             batch: Optional[int] = None, max_seq: Optional[int] = None,
             cfg=None) -> CellPlan:
    cfg = cfg or arch.make_config()
    B, S = batch or shape.params["batch"], shape.params["seq"]
    dp = policy.dp_spec
    n_active = cfg.active_param_count()
    cdt = "bf16" if cfg.compute_dtype == torch.bfloat16 else "fp32"
    meta = {"loop_scale": cfg.n_groups}

    if shape.kind == "train":
        dtype = lm_train_dtype(cfg, policy)
        params_abs = tf_lib.abstract_params(cfg, dtype=dtype)
        specs = tf_lib.train_pspecs(cfg, policy, dtype=dtype)
        opt_abs = _abstract_opt_state(params_abs, dtype)
        batch_abs = {"tokens": _meta((B, S), torch.int32),
                     "labels": _meta((B, S), torch.int32)}
        batch_specs = {"tokens": (dp, None), "labels": (dp, None)}

        def step(device, draw: bool = False, seed: int = 0):
            blocks = None if draw else _blocks(params_abs, specs, policy,
                                               device)
            cell = lm_train_cell(arch, shape, policy, blocks, cfg=cfg,
                                 seed=seed, device=device)
            return cell.step, (cell.params, cell.opt_state,
                               _lm_tokens(B, S, cfg.vocab, device, draw,
                                          seed))

        return CellPlan(arch.name, shape.name, "train", step,
                        (params_abs, opt_abs, batch_abs),
                        (specs, _opt_state_specs(specs), batch_specs),
                        6.0 * n_active * B * S, policy, cdt,
                        donate_argnums=(0, 1), meta=meta)

    params_abs = tf_lib.abstract_params(cfg, dtype=torch.bfloat16)
    specs = tf_lib.param_pspecs(cfg, policy)
    fsdp = 2.0 * cfg.param_count() / policy.tp > SERVE_FSDP_BYTES
    if fsdp:
        specs = fsdp_specs(params_abs, specs, policy)

    def model(device, draw: bool, seed: int):
        if draw:
            if fsdp and policy.dp > 1:
                raise ValueError(f"{arch.name}: drawn serving weights under "
                                 "FSDP")
            return shard_transformer(None, cfg, policy, device=device,
                                     dtype=torch.bfloat16, seed=seed)
        return _blocks(params_abs, specs, policy, device)

    def serving(fn):
        """``fn(model, ...)`` over the rank's blocks (a dict) or the model
        a draw built."""
        def run(m, *rest):
            if isinstance(m, dict):
                m = _serving_model(cfg, policy, m, specs, fsdp)
            return fn(m, *rest)
        return run

    if shape.kind == "prefill":
        decode = tf_lib.DecodePolicy(batch_axes=tuple(policy.dp_axes))
        prefill = tf_lib.make_prefill_step(cfg, max_seq=max_seq,
                                           policy=policy, decode=decode)

        def step(device, draw: bool = False, seed: int = 0):
            tokens = _lm_tokens(B, S, cfg.vocab, device, draw,
                                seed)["tokens"]
            return serving(prefill), (model(device, draw, seed), tokens)

        return CellPlan(arch.name, shape.name, "prefill", step,
                        (params_abs, _meta((B, S), torch.int32)),
                        (specs, (dp, None)), 2.0 * n_active * B * S, policy,
                        cdt, meta=meta)

    # decode
    long_ctx = S >= 2 ** 19
    decode = tf_lib.DecodePolicy(
        cache_seq_axes=("data", "model") if long_ctx else ("model",),
        batch_axes=() if B < policy.dp else tuple(policy.dp_axes))
    serve = tf_lib.make_serve_step(cfg, S, policy=policy, decode=decode)
    cache_abs = tf_lib.abstract_cache(cfg, B, S)
    cache_specs = tf_lib.cache_pspecs(cfg, policy, decode)
    bat = decode.batch_axes if len(decode.batch_axes) > 1 else (
        decode.batch_axes[0] if decode.batch_axes else None)

    def step(device, draw: bool = False, seed: int = 0):
        cache = tf_lib.init_cache(cfg, B, S, device=device, policy=policy,
                                  decode=decode)
        tokens = _lm_tokens(B, 1, cfg.vocab, device, draw, seed)["tokens"]
        return serving(serve), (model(device, draw, seed), cache, tokens,
                                S - 1)

    return CellPlan(arch.name, shape.name, "decode", step,
                    (params_abs, cache_abs, _meta((B, 1), torch.int32),
                     _meta((), torch.int32)),
                    (specs, cache_specs, (bat, None), ()),
                    2.0 * n_active * B, policy, cdt, donate_argnums=(1,),
                    meta={"cache_seq_axes": decode.cache_seq_axes, **meta})


# ---- GNN cells -------------------------------------------------------------

def _wigner_abstract(cfg, E: int) -> dict:
    """Pre-chunked when the convolution is edge-tiled, as the reference
    lays it out."""
    chunks = max(getattr(cfg, "edge_chunks", 1), 1)
    return {l: _meta((chunks, E // chunks, cfg.m_dim(l), 2 * l + 1)
                     if chunks > 1 else (E, cfg.m_dim(l), 2 * l + 1),
                     torch.float32)
            for l in range(cfg.l_max + 1)}


def _gnn_graph_abstract(arch: ArchDef, shape: ShapeSpec,
                        cfg) -> tuple[GraphBatch, dict]:
    """The reference's global graph batch as meta tensors (int32 indices)
    and its padded sizes."""
    p = shape.params
    N, E = _gnn_sizes(shape)
    if getattr(cfg, "edge_chunks", 1) > 1:
        E = _pad(E, cfg.edge_chunks * 32)
    molecule = shape.name == "molecule"
    n_graphs = p.get("batch", 1)
    f32 = lambda *s: _meta(s, torch.float32)  # noqa: E731
    i32 = lambda *s: _meta(s, torch.int32)  # noqa: E731
    kw: dict[str, Any] = dict(
        node_feat=f32(N, p["d_feat"]), senders=i32(E), receivers=i32(E),
        node_mask=f32(N), edge_mask=f32(E),
        n_graphs=n_graphs if molecule else 1)
    if molecule:
        kw["graph_ids"] = i32(N)
    name = arch.name
    if name in ("gcn-cora", "gatedgcn"):
        kw["labels"] = i32(n_graphs) if molecule else i32(N)
    if name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = f32(E, cfg.d_edge_in)
    if name == "meshgraphnet":
        kw["labels"] = f32(N, cfg.d_out)
    elif name == "equiformer-v2":
        kw["wigner"] = _wigner_abstract(cfg, E)
        kw["labels"] = f32(n_graphs if molecule else 1, cfg.d_out)
        kw["positions"] = f32(N, 3)
    return GraphBatch(**kw), {"N": N, "E": E}


def _even_shard(g_abs: GraphBatch, specs: GraphBatch, policy, device,
                n_total: int) -> GraphShard:
    """This rank's shard of ``g_abs`` in the reference's even split by
    position (``E / n`` edges a rank, every edge real), with the fields a
    :class:`GraphShard` holds: indices widened to int64 as
    ``GraphBatch.to`` widens them, edge ids and GCN coefficients.  The
    port's own cut (:func:`shard_graph`) gives each rank its receivers'
    edges, a count that depends on the data."""
    def block(t, spec):
        if t is None:
            return None
        dt = torch.int64 if not t.dtype.is_floating_point else t.dtype
        return torch.zeros(_local_shape(t.shape, spec, policy), dtype=dt,
                           device=device)

    kw = {f: block(getattr(g_abs, f), getattr(specs, f))
          for f in ("node_feat", "senders", "receivers", "edge_feat",
                    "labels", "node_mask", "edge_mask", "graph_ids",
                    "positions")}
    if g_abs.wigner is not None:
        kw["wigner"] = {l: block(w, specs.wigner[l])
                        for l, w in g_abs.wigner.items()}
    e_loc = kw["senders"].shape[0]
    axes = specs.node_feat[0]
    return GraphShard(
        **kw, n_graphs=g_abs.n_graphs,
        edge_ids=torch.zeros((e_loc,), dtype=torch.int64, device=device),
        sym_norm=torch.zeros((e_loc,), dtype=torch.float32, device=device),
        n_total=n_total, node_group=policy.group(axes),
        n_ranks=policy.n_devices)


_EVEN_SPLIT = ("the reference's even split by position, E / n edges a "
               "rank; the port's run gives each rank its receivers' edges "
               "(shard_graph), a count that depends on the data")


def _gnn_flops(arch: ArchDef, cfg, N: int, E: int) -> float:
    """The reference's forward-FLOP estimates; train = 3x forward."""
    if arch.name == "gcn-cora":
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [
            cfg.n_classes]
        fwd = sum(2.0 * N * a * b + 2.0 * E * b
                  for a, b in zip(dims[:-1], dims[1:]))
    elif arch.name == "gatedgcn":
        d = cfg.d_hidden
        fwd = cfg.n_layers * (2.0 * N * 5 * d * d + 2.0 * E * 5 * d)
        fwd += 2.0 * N * cfg.d_in * d + 2.0 * E * cfg.d_edge_in * d
    elif arch.name == "meshgraphnet":
        d = cfg.d_hidden
        per = 2.0 * E * (3 * d * d + d * d) + 2.0 * N * (2 * d * d + d * d)
        fwd = cfg.n_layers * per + 2.0 * N * (cfg.d_in * d + d * d) \
            + 2.0 * E * (cfg.d_edge_in * d + d * d)
    else:  # equiformer-v2
        C = cfg.d_hidden
        rot = sum(cfg.m_dim(l) * (2 * l + 1)
                  for l in range(cfg.l_max + 1)) * C
        n0 = (cfg.l_max + 1) * C
        so2 = n0 ** 2 + 2 * sum((len(cfg.ls_for_m(m)) * C) ** 2
                                for m in range(1, cfg.m_max + 1))
        fwd = cfg.n_layers * (2.0 * E * (2 * rot + so2) + 2.0 * N * 4 * C * C)
    return 3.0 * fwd


def _gnn_plan(arch: ArchDef, shape: ShapeSpec, policy, *,
              cfg=None) -> CellPlan:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..params import module_tree

    cfg = cfg or gnn_config(arch, shape)
    g_abs, sizes = _gnn_graph_abstract(arch, shape, cfg)
    g_specs = gnn_graph_specs(arch.name, g_abs, policy)
    _, model_cls = GNN_MODELS[arch.name]
    with FakeTensorMode():
        params_abs = tree_map(lambda t: _meta(t.shape, t.dtype),
                              module_tree(model_cls(cfg, device="cpu")))
    param_specs = tree_map(lambda t: (None,) * t.dim(), params_abs)
    opt_abs = _abstract_opt_state(params_abs)

    def step(device, draw: bool = False, seed: int = 0):
        if draw:
            raise ValueError("a drawn GNN cell takes a graph: "
                             "gnn_train_cell and its meta['shard']")
        cell = gnn_train_cell(arch, shape, policy,
                              _blocks(params_abs, param_specs, policy,
                                      device), cfg=cfg, device=device)
        g = _even_shard(g_abs, g_specs, policy, device, sizes["N"])
        return cell.step, (cell.params, cell.opt_state, g)

    # The reference counts GCN's Python-loop layers fully and one scanned
    # layer of the others.
    sizes["loop_scale"] = 1 if arch.name == "gcn-cora" else cfg.n_layers
    return CellPlan(arch.name, shape.name, "train", step,
                    (params_abs, opt_abs, g_abs),
                    (param_specs, _opt_state_specs(param_specs), g_specs),
                    _gnn_flops(arch, cfg, sizes["N"], sizes["E"]), policy,
                    "fp32", donate_argnums=(0, 1), meta=sizes,
                    notes={"edge_layout": _EVEN_SPLIT})


# ---- DLRM cells ------------------------------------------------------------

def _dlrm_flops(cfg, B: int, *, train: bool) -> float:
    bot = sum(2.0 * a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1],
                                          cfg.bot_mlp))
    top_dims = (cfg.interaction_dim(),) + cfg.top_mlp
    top = sum(2.0 * a * b for a, b in zip(top_dims[:-1], top_dims[1:]))
    f = cfg.n_sparse + 1
    inter = 2.0 * f * f * cfg.embed_dim
    fwd = B * (bot + top + inter)
    return 3.0 * fwd if train else fwd


#: The candidates a retrieval returns (the reference's ``top_k``).
RETRIEVAL_TOP_K = 128


def retrieval_step(policy) -> Callable:
    """The reference's retrieval cell under ``policy``: ``retrieve(model,
    query, candidates)`` with ``model`` the rank's :class:`ShardedDLRM`,
    ``query["dense"]`` (1, 13) on every rank and ``candidates`` this
    rank's block of the (Nc, d) candidates (split over every axis): the
    block's scores (``dlrm.score_candidates``), its top
    :data:`RETRIEVAL_TOP_K`, and the top of every rank's (scores and
    global indices all-gathered over every axis, tagged
    ``"retrieval"``)."""
    @torch.inference_mode()
    def retrieve(model, query: dict, candidates: torch.Tensor):
        scores = dlrm_lib.score_candidates(model, query, candidates)
        k = RETRIEVAL_TOP_K
        vals, idx = torch.topk(scores, min(k, scores.shape[0]))
        if policy.n_devices > 1:
            everyone = policy.group(policy.all_axes)
            idx = idx + policy.coord(policy.all_axes) * candidates.shape[0]
            vals = comm.all_gather(vals, everyone, 0, tag="retrieval")
            idx = comm.all_gather(idx, everyone, 0, tag="retrieval")
            vals, at = torch.topk(vals, k)
            idx = idx[at]
        return vals, idx

    return retrieve


def _dlrm_plan(arch: ArchDef, shape: ShapeSpec, policy, *,
               batch: Optional[int] = None, row_cap: Optional[int] = None,
               cfg=None) -> CellPlan:
    from dataclasses import replace

    cfg = cfg or arch.make_config()
    if row_cap:
        cfg = replace(cfg, vocab_sizes=tuple(min(v, row_cap)
                                             for v in cfg.vocab_sizes))
    B = batch or shape.params["batch"]
    dp = policy.dp_spec
    params_abs = dlrm_lib.abstract_params(cfg)
    specs = dlrm_lib.param_pspecs(cfg, policy)
    pad = sum(cfg.embed_dim * 4 for s in specs["tables"] if s[0] is not None)
    meta: dict[str, Any] = {}
    if row_cap:
        meta["row_cap"] = row_cap

    def model(device, draw: bool, seed: int):
        if draw:
            return shard_dlrm(None, cfg, policy, device=device, seed=seed)
        tables = [torch.empty((t.shape[0] // policy.size(s[0]) + 1
                               if s[0] is not None else t.shape[0],
                               t.shape[1]), device=device)
                  for t, s in zip(params_abs["tables"], specs["tables"])]
        mlps = {name: _blocks(params_abs[name], specs[name], policy, device)
                for name in ("bot", "top")}
        return dlrm_lib.ShardedDLRM(cfg, policy, tables, mlps["bot"],
                                    mlps["top"])

    if shape.kind == "retrieval":
        Nc = _pad(shape.params["n_candidates"])
        axes = policy.all_axes
        dense = {"dense": _meta((1, cfg.n_dense), torch.float32)}

        def step(device, draw: bool = False, seed: int = 0):
            gen = torch.Generator(device="cpu").manual_seed(seed)
            n = Nc // policy.n_devices
            q = torch.rand((1, cfg.n_dense), generator=gen) if draw else \
                torch.zeros((1, cfg.n_dense))
            c = torch.randn((n, cfg.embed_dim), generator=gen) if draw else \
                torch.zeros((n, cfg.embed_dim))
            return retrieval_step(policy), (
                model(device, draw, seed), {"dense": q.to(device)},
                c.to(device))

        return CellPlan(arch.name, shape.name, "retrieval", step,
                        (params_abs, dense,
                         _meta((Nc, cfg.embed_dim), torch.float32)),
                        (specs, {"dense": (None, None)}, (axes, None)),
                        2.0 * Nc * cfg.embed_dim, policy, "fp32",
                        pad_bytes=pad, meta={"n_candidates": Nc, **meta})

    batch_abs = {"dense": _meta((B, cfg.n_dense), torch.float32),
                 "sparse": _meta((B, cfg.n_sparse, cfg.multi_hot),
                                 torch.int32),
                 "labels": _meta((B,), torch.int32)}
    batch_specs = {"dense": (dp, None), "sparse": (dp, None, None),
                   "labels": (dp,)}

    def criteo(device, draw: bool, seed: int) -> dict:
        if not draw:
            return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                    for k, t in batch_abs.items()}
        from ..data.synthetic import criteo_batch
        out = criteo_batch(seed, 0, batch=B, n_dense=cfg.n_dense,
                           vocab_sizes=cfg.vocab_sizes,
                           multi_hot=cfg.multi_hot)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in out.items()}

    if shape.kind == "train":
        def step(device, draw: bool = False, seed: int = 0):
            cell = dlrm_train_cell(arch, shape, policy,
                                   model(device, draw, seed), cfg=cfg,
                                   device=device)
            return cell.step, (cell.params, cell.opt_state,
                               criteo(device, draw, seed))

        opt_abs = _abstract_opt_state(params_abs)
        return CellPlan(arch.name, shape.name, "train", step,
                        (params_abs, opt_abs, batch_abs),
                        (specs, _opt_state_specs(specs), batch_specs),
                        _dlrm_flops(cfg, B, train=True), policy, "fp32",
                        donate_argnums=(0, 1),
                        # The zero rows of the tables and of both moments.
                        pad_bytes=3 * pad, meta=meta)

    def step(device, draw: bool = False, seed: int = 0):
        return (partial(dlrm_lib.forward, cfg, policy=policy),
                (model(device, draw, seed), criteo(device, draw, seed)))

    # The reference's serving batch carries its labels too (unread).
    return CellPlan(arch.name, shape.name, "serve", step,
                    (params_abs, batch_abs), (specs, batch_specs),
                    _dlrm_flops(cfg, B, train=False), policy, "fp32",
                    pad_bytes=pad, meta=meta)


# ---- Entry points ----------------------------------------------------------

def plan(arch, shape_spec, policy, *, batch: Optional[int] = None,
         row_cap: Optional[int] = None, max_seq: Optional[int] = None,
         cfg=None) -> CellPlan:
    """The plan of one cell under ``policy``.  ``batch`` cuts an LM's or
    DLRM's batch, ``row_cap`` caps every DLRM table's rows, ``cfg``
    replaces the published config (a smoke config): the cuts of a cell
    held on one card.  ``max_seq`` gives a prefill's cache room for
    decode steps after the prompt."""
    arch = get_arch(arch) if isinstance(arch, str) else arch
    shape = (arch.shapes[shape_spec] if isinstance(shape_spec, str)
             else shape_spec)
    if arch.family == "lm":
        return _lm_plan(arch, shape, policy, batch=batch, max_seq=max_seq,
                        cfg=cfg)
    if arch.family == "gnn":
        return _gnn_plan(arch, shape, policy, cfg=cfg)
    if arch.family == "recsys":
        return _dlrm_plan(arch, shape, policy, batch=batch, row_cap=row_cap,
                          cfg=cfg)
    raise ValueError(arch.family)


def build_cell(arch_name: str, shape_name: str, mesh, *,
               batch: Optional[int] = None, row_cap: Optional[int] = None,
               **policy_kw) -> CellPlan:
    """The reference's ``build_cell``: the plan of (``arch_name``,
    ``shape_name``) on ``mesh`` (a ``DeviceMesh`` to trace, or an
    ``AbstractMesh`` for the plan alone) under ``make_policy(mesh,
    **policy_kw)``.  Raises for a skipped cell."""
    arch = get_arch(arch_name)
    if shape_name in arch.skips:
        raise ValueError(f"cell ({arch_name}, {shape_name}) is skipped: "
                         f"{arch.skips[shape_name]}")
    return plan(arch, arch.shapes[shape_name], make_policy(mesh, **policy_kw),
                batch=batch, row_cap=row_cap)
