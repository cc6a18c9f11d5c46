"""DLRM (Naumov et al., arXiv:1906.00091), served and trained: the
reference's ``models/dlrm.py`` in PyTorch, with every embedding bag through
kernel K6.

13 dense features go through the bottom MLP 512-256-128; 26 categorical
features each pick rows of their own ``(V, 128)`` table, pooled by K6
(``kernels.ops.embedding_bag``, once per table and forward); the 27 vectors
meet in the pairwise-dot interaction; the top MLP 1024-1024-512-256-1 gives
one logit per sample.  The MLP and interaction products are
``torch.matmul`` in f32, as the reference leaves them to XLA: they stay in
full fp32 only while TF32 is off (PyTorch's default), which the caller
keeps.

Training (:func:`loss_fn`) takes the same forward with each bag through
``ops.embedding_bag_autograd``: K6 forward, and the table gradient by the
transposed gather in plain PyTorch, as the reference's gradient is XLA's
scatter-add.  Under a policy it runs K6 the same way on each rank's table
shards (:func:`logits` with ``policy=``), and :func:`sync_grads` makes the
gradients whole and keeps every shard's zero row zero.  Serving under a
policy (:func:`forward`) is that same :func:`logits` with no gradient.

Distribution (``policy=``): :func:`param_pspecs` row-shards each table
over every mesh axis where its rows divide, over ``model`` alone where only
that divides, and replicates it otherwise; the MLPs are replicated.  One
rank holds a :class:`ShardedDLRM` (``repro_torch.params.shard_dlrm``), and
:func:`vocab_parallel_embeddings` pools each table's bags with K6 on the
rank's shard, then sums the shards' partial bags with one all-reduce per
sharding (the Megatron vocab-parallel pattern).  K6 stays as it is: each
shard carries one zero row at local index ``rows``, and an id outside the
shard reads it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..backend import resolve_device
from ..distributed import comm
from ..kernels import ops
from .common import mlp_apply

__all__ = ["CRITEO_1TB_VOCABS", "DLRMConfig", "DLRM", "embedding_bag",
           "dot_interaction", "serve", "score_candidates", "logits",
           "loss_fn", "abstract_params", "param_pspecs", "table_shards",
           "ShardedDLRM",
           "shard_ids", "vocab_parallel_embeddings", "forward",
           "sync_grads"]

# MLPerf Criteo-1TB per-feature cardinalities (day-0..22 preprocessing,
# capped at 40M rows as in the MLPerf reference implementation).
CRITEO_1TB_VOCABS: tuple[int, ...] = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36)


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_sizes: tuple[int, ...] = CRITEO_1TB_VOCABS
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"
    multi_hot: int = 1            # lookups per sparse feature (bag size)

    def __post_init__(self):
        if len(self.vocab_sizes) != self.n_sparse:
            raise ValueError(f"{len(self.vocab_sizes)} vocab sizes for "
                             f"{self.n_sparse} sparse features")
        if self.bot_mlp[-1] != self.embed_dim:
            raise ValueError(f"bottom MLP ends at {self.bot_mlp[-1]}, not "
                             f"the embed dim {self.embed_dim}")

    def interaction_dim(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        emb = sum(self.vocab_sizes) * self.embed_dim
        bot = sum(a * b + b for a, b in zip((self.n_dense,) + self.bot_mlp[:-1],
                                            self.bot_mlp))
        top_dims = (self.interaction_dim(),) + self.top_mlp
        top = sum(a * b + b for a, b in zip(top_dims[:-1], top_dims[1:]))
        return emb + bot + top


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  weights: Optional[torch.Tensor] = None,
                  combine: str = "sum") -> torch.Tensor:
    """(B, bag) ids -> (B, d) pooled rows.  ``"sum"`` is K6; ``"mean"`` is
    K6's sum over the bag size.  With per-id ``weights`` the bag stays
    plain PyTorch (take, scale, reduce) on every device: K6 has no weights,
    and ``DLRM.forward`` never passes any."""
    if combine not in ("sum", "mean"):
        raise ValueError(combine)
    if weights is not None:
        vecs = table[indices.long()] * weights[..., None]
        return vecs.sum(dim=1) if combine == "sum" else vecs.mean(dim=1)
    pooled = ops.embedding_bag(table, indices)
    return pooled if combine == "sum" else pooled / indices.shape[1]


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """(B, F, d) -> (B, F*(F-1)/2) lower-triangle pairwise dots, in the
    row-major order of ``jnp.tril_indices(F, k=-1)``."""
    f = vectors.shape[1]
    prods = torch.bmm(vectors, vectors.transpose(1, 2))
    iu, ju = torch.tril_indices(f, f, -1, device=vectors.device)
    return prods[:, iu, ju]


def _weight(*shape: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class DLRM(nn.Module):
    """The f32 weights of one config on one device (CUDA by default).

    With a ``generator`` on that device the weights are drawn in place
    there: tables ``normal_(0, 0.02)``, MLP weights He-normal, biases zero.
    So the full-size tables never pass through host memory.  Without one
    they are zeros until :func:`repro_torch.params.load_dlrm` fills them.
    On CUDA the weights must fit the card's free memory, or this raises.
    """

    def __init__(self, cfg: DLRMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 tables: Optional[list] = None):
        super().__init__()
        dev = resolve_device(device)
        if tables is not None:
            # Wrap the caller's f32 tables (views share their storage); only
            # the MLPs are allocated here.
            self.cfg = cfg
            self.tables = nn.ParameterList(
                nn.Parameter(t, requires_grad=False) for t in tables)
            self._mlps(cfg, dev, generator)
            return
        if dev.type == "cuda":
            need = 4 * cfg.param_count()
            free, _ = torch.cuda.mem_get_info(dev)
            if need > free:
                raise MemoryError(f"{cfg.name}: {need / 1e9:.2f} GB of f32 "
                                  f"weights, {free / 1e9:.2f} GB free on "
                                  f"{dev}")
        self.cfg = cfg
        self.tables = nn.ParameterList(_weight(v, cfg.embed_dim, device=dev)
                                       for v in cfg.vocab_sizes)
        with torch.no_grad():
            for t in self.tables:
                t.zero_()
                if generator is not None:
                    t.normal_(0.0, 0.02, generator=generator)
        self._mlps(cfg, dev, generator)

    def _mlps(self, cfg: DLRMConfig, dev, generator) -> None:
        """The MLPs: zero biases, weights zero or He-normal from
        ``generator``, drawn after the tables."""
        bot = (cfg.n_dense,) + cfg.bot_mlp
        top = (cfg.interaction_dim(),) + cfg.top_mlp
        for name, dims in (("bot", bot), ("top", top)):
            setattr(self, f"{name}_w", nn.ParameterList(
                _weight(a, b, device=dev) for a, b in zip(dims[:-1], dims[1:])))
            setattr(self, f"{name}_b", nn.ParameterList(
                _weight(b, device=dev) for b in dims[1:]))
        with torch.no_grad():
            for p in (*self.bot_w, *self.bot_b, *self.top_w, *self.top_b):
                p.zero_()
            if generator is not None:
                for w in (*self.bot_w, *self.top_w):
                    w.normal_(0.0, math.sqrt(2.0 / w.shape[0]),
                              generator=generator)

    @property
    def device(self) -> torch.device:
        return self.tables[0].device

    def mlp(self, name: str) -> dict:
        """The ``"bot"`` or ``"top"`` MLP as ``{"w": [...], "b": [...]}``."""
        return {"w": list(getattr(self, f"{name}_w")),
                "b": list(getattr(self, f"{name}_b"))}

    def bottom(self, dense: torch.Tensor) -> torch.Tensor:
        """(B, n_dense) -> (B, d): the bottom MLP, ReLU after every layer."""
        return mlp_apply(self.mlp("bot"), dense, final_act=True)

    def top_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, 27, d) features, the bottom output first -> (B,) logits: the
        dot interaction, the bottom output beside it, the top MLP."""
        top_in = torch.cat([feats[:, 0], dot_interaction(feats)], dim=-1)
        return mlp_apply(self.mlp("top"), top_in)[:, 0]

    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        """batch: dense (B, 13) f32, sparse (B, 26, multi_hot) int32 on the
        model's device -> logits (B,).  K6 writes each table's bags straight
        into its slot of the (B, 27, d) features."""
        dense, sparse = batch["dense"], batch["sparse"]
        cfg = self.cfg
        feats = torch.empty((dense.shape[0], cfg.n_sparse + 1, cfg.embed_dim),
                            dtype=torch.float32, device=dense.device)
        feats[:, 0] = self.bottom(dense)
        for t, table in enumerate(self.tables):
            ops.embedding_bag(table, sparse[:, t, :], out=feats[:, t + 1])
        return self.top_logits(feats)


def logits(model, batch: dict, *, policy=None) -> torch.Tensor:
    """The forward that autograd can differentiate: batch dense (B, 13) f32,
    sparse (B, 26, multi_hot) int32 -> logits (B,), each bag through
    ``ops.embedding_bag_autograd`` (K6 on the card).

    Under ``policy``, ``model`` is the rank's :class:`ShardedDLRM` and
    every rank passes the same batch: K6 pools each table's bags on the
    rank's shard, the shards' partial bags are summed (``comm.all_reduce``,
    whose backward passes the gradient through), and the rank takes its
    ``B / n_devices`` rows (``comm.split``, whose backward all-gathers
    their gradients, so each shard's gradient covers the whole batch) for
    the data-parallel interaction and top MLP; returns those rows'
    logits."""
    if policy is not None:
        return _sharded_logits(model, batch, policy)
    dense, sparse = batch["dense"], batch["sparse"]
    feats = torch.stack([model.bottom(dense)] + [
        ops.embedding_bag_autograd(table, sparse[:, t, :])
        for t, table in enumerate(model.tables)], dim=1)
    return model.top_logits(feats)


def loss_fn(model, batch: dict, *, policy=None
            ) -> tuple[torch.Tensor, dict]:
    """Binary cross-entropy on the click labels (B,) and accuracy, in f32;
    ``(loss, {"loss", "acc"})``.

    Under ``policy`` (see :func:`logits`) the first value is this rank's
    share of the global mean, its rows' sum over the global B, whose
    gradients :func:`sync_grads` makes whole; the metrics are global."""
    if policy is None:
        lg = logits(model, batch)
        labels = batch["labels"].float()
        loss = -torch.mean(labels * F.logsigmoid(lg)
                           + (1 - labels) * F.logsigmoid(-lg))
        acc = torch.mean(((lg > 0) == (labels > 0.5)).float())
        return loss, {"loss": loss, "acc": acc}
    b = batch["labels"].shape[0]
    lg = logits(model, batch, policy=policy)
    labels = _rows(batch["labels"], policy).float()
    total = -torch.sum(labels * F.logsigmoid(lg)
                       + (1 - labels) * F.logsigmoid(-lg))
    hits = torch.sum(((lg > 0) == (labels > 0.5)).float())
    everyone = policy.group(policy.all_axes)
    sums = comm.all_reduce(torch.stack([total.detach(), hits]), everyone,
                           tag="metrics")
    return total / b, {"loss": sums[0] / b, "acc": sums[1] / b}


def serve(model: DLRM, batch: dict) -> np.ndarray:
    """One request: the numpy ``dense`` and ``sparse`` of ``batch`` copied
    to the model's device, the forward, and the (B,) logits copied back."""
    dev = model.device
    logits = model({"dense": torch.from_numpy(batch["dense"]).to(dev),
                    "sparse": torch.from_numpy(batch["sparse"]).to(dev)})
    return logits.cpu().numpy()


@torch.inference_mode()
def score_candidates(model, query: dict,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Retrieval scoring: one query's user vector (the bottom MLP of its
    (1, 13) dense features) dotted against (Nc, d) candidate item
    embeddings, one matrix-vector product -> (Nc,) f32.  ``model`` is a
    :class:`DLRM` or a rank's :class:`ShardedDLRM` (whose MLPs are
    replicated)."""
    bot = model.bottom(query["dense"])
    return (candidates @ bot[0]).float()


# ---------------------------------------------------------------------------
# Vocab-parallel tables
# ---------------------------------------------------------------------------

def abstract_params(cfg: DLRMConfig) -> dict:
    """The reference's parameter tree as ``meta`` tensors of the global
    shapes, f32: ``tables`` (V, d) each, ``bot`` and ``top`` ``{"w":
    [...], "b": [...]}``.  Nothing is allocated."""
    def meta(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device="meta")

    out = {"tables": [meta(v, cfg.embed_dim) for v in cfg.vocab_sizes]}
    for name, dims in (("bot", (cfg.n_dense,) + cfg.bot_mlp),
                       ("top", (cfg.interaction_dim(),) + cfg.top_mlp)):
        out[name] = {"w": [meta(a, b) for a, b in zip(dims[:-1], dims[1:])],
                     "b": [meta(b) for b in dims[1:]]}
    return out


def table_shards(v: int, policy) -> int:
    """How many ways a table of ``v`` rows shards: over every axis, over
    ``model`` alone, or not at all (1)."""
    if v % policy.n_devices == 0:
        return policy.n_devices
    if v % policy.tp == 0:
        return policy.tp
    return 1


def param_pspecs(cfg: DLRMConfig, policy) -> dict:
    """Tables row-sharded over ALL mesh axes where the row count divides
    (the 40M-row Criteo tables shard 512 ways, about 10 MB a device instead
    of 20 GB replicated); tp-only or replicated as divisibility degrades.
    MLPs are replicated (DP)."""
    tp = policy.tp_axis
    all_axes = policy.all_axes

    def table_spec(v: int) -> tuple:
        if v % policy.n_devices == 0:
            return (all_axes, None)
        if v % policy.tp == 0:
            return (tp, None)
        return (None, None)

    bot = {"w": [(None, None)] * len(cfg.bot_mlp),
           "b": [(None,)] * len(cfg.bot_mlp)}
    top = {"w": [(None, None)] * len(cfg.top_mlp),
           "b": [(None,)] * len(cfg.top_mlp)}
    return {"tables": [table_spec(v) for v in cfg.vocab_sizes],
            "bot": bot, "top": top}


class ShardedDLRM:
    """One rank's DLRM under ``policy``: each table's shard of ``rows``
    rows (``table_shards``) with one zero row appended (local index
    ``rows``; a replicated table has none), and the replicated MLPs as
    ``{"w": [...], "b": [...]}``.  ``repro_torch.params.shard_dlrm``
    builds it."""

    def __init__(self, cfg: DLRMConfig, policy, tables: list, bot: dict,
                 top: dict):
        self.cfg, self.policy = cfg, policy
        self.tables, self.bot, self.top = tables, bot, top
        self.shards = [table_shards(v, policy) for v in cfg.vocab_sizes]
        self.rows = [v // s for v, s in zip(cfg.vocab_sizes, self.shards)]

    @property
    def device(self) -> torch.device:
        return self.tables[0].device

    def bottom(self, dense: torch.Tensor) -> torch.Tensor:
        """(B, n_dense) -> (B, d): :meth:`DLRM.bottom` on the replicated
        MLP."""
        return mlp_apply(self.bot, dense, final_act=True)

    def tree(self) -> dict:
        """The rank's state as a tree: ``{"tables", "bot", "top"}``, the
        reference's layout with the rank's table shards (zero rows
        included)."""
        return {"tables": self.tables, "bot": self.bot, "top": self.top}

    @classmethod
    def from_tree(cls, cfg: DLRMConfig, policy, tree: dict) -> "ShardedDLRM":
        return cls(cfg, policy, tree["tables"], tree["bot"], tree["top"])

    def single_device_view(self) -> DLRM:
        """At world size 1: a :class:`DLRM` whose tables are the views
        ``shard[:rows]`` of this one's (the card holds one copy) and whose
        MLPs are copies."""
        if self.policy.n_devices != 1:
            raise ValueError("a single-device view needs world size 1")
        model = DLRM(self.cfg, device=self.device,
                     tables=[t[:r] for t, r in zip(self.tables, self.rows)])
        with torch.no_grad():
            for name in ("bot", "top"):
                mlp = model.mlp(name)
                for key in ("w", "b"):
                    for dst, src in zip(mlp[key], getattr(self, name)[key]):
                        dst.copy_(src)
        return model


def shard_ids(model: ShardedDLRM, t: int, ids: torch.Tensor) -> torch.Tensor:
    """Table ``t``'s ids (int32) -> ids into this rank's shard: an id the
    shard holds at its local row, any other at the zero row ``rows``.  A
    table without a zero row (replicated) keeps its ids."""
    rows, table = model.rows[t], model.tables[t]
    if table.shape[0] != rows + 1:
        return ids
    policy = model.policy
    axes = policy.all_axes if model.shards[t] == policy.n_devices \
        else policy.tp_axis
    loc = ids - policy.coord(axes) * rows
    return torch.where((loc >= 0) & (loc < rows), loc, rows).to(torch.int32)


def vocab_parallel_embeddings(cfg: DLRMConfig, model: ShardedDLRM,
                              sparse: torch.Tensor, policy) -> torch.Tensor:
    """Row-sharded embedding bags: K6 over each table's local shard
    (``ops.embedding_bag_autograd``; ids outside the shard read its zero
    row), then one all-reduce over every rank for the tables sharded over
    all axes and one over ``model`` for those sharded over it alone
    (``comm.all_reduce``, whose backward passes the gradient through).
    ``sparse`` (B, 26, hot) is the same on every rank; returns (B, 26, d),
    the same on every rank.

    Traffic: the all-reduces of (B, n_sharded_tables, d), the DLRM analogue
    of the paper's loadvert terms; ``core.comm_model.
    dlrm_embedding_exchange`` models the all-to-all alternative."""
    bags = [ops.embedding_bag_autograd(table, shard_ids(model, t,
                                                        sparse[:, t, :]))
            for t, table in enumerate(model.tables)]
    kinds = {policy.n_devices: [], policy.tp: []}
    for t, (table, rows) in enumerate(zip(model.tables, model.rows)):
        if table.shape[0] == rows + 1:
            kinds[model.shards[t]].append(t)
    groups = {policy.n_devices: policy.all_axes, policy.tp: policy.tp_axis}
    for n, tabs in kinds.items():
        if tabs:
            red = comm.all_reduce(torch.stack([bags[t] for t in tabs], 1),
                                  policy.group(groups[n]), tag="embedding")
            for j, t in enumerate(tabs):
                bags[t] = red[:, j]
    return torch.stack(bags, 1)


def _rows(t: torch.Tensor, policy) -> torch.Tensor:
    """This rank's ``B / n_devices`` rows of a batch tensor."""
    n = policy.n_devices
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} over {n} ranks")
    lo = policy.coord(policy.all_axes) * (t.shape[0] // n)
    return t[lo:lo + t.shape[0] // n]


def _sharded_logits(model: ShardedDLRM, batch: dict,
                    policy) -> torch.Tensor:
    emb = vocab_parallel_embeddings(model.cfg, model, batch["sparse"], policy)
    emb = comm.split(emb, policy.group(policy.all_axes), 0, tag="embedding")
    bot = mlp_apply(model.bot, _rows(batch["dense"], policy), final_act=True)
    feats = torch.cat([bot[:, None], emb], dim=1)
    top_in = torch.cat([feats[:, 0], dot_interaction(feats)], dim=-1)
    return mlp_apply(model.top, top_in)[:, 0]


@torch.no_grad()
def sync_grads(cfg: DLRMConfig, policy, grads: dict) -> torch.Tensor:
    """One rank's DLRM gradients (``{"tables", "bot", "top"}``, the
    :class:`ShardedDLRM` layout) made whole, in place, and their global
    norm.  Each sharded table's zero row gets a zero gradient: out-of-shard
    ids read it, so their gradients land there, and an optimizer step would
    make it non-zero and add garbage to every later out-of-shard bag.  The
    tables' gradients are whole already (every rank pools the whole batch);
    the MLPs', each rank's rows only, are summed over every rank (tagged
    ``"grad_dp"``).  The norm sums each table shard's squares over the axes
    that shard it and counts replicated leaves once."""
    from ..distributed.sharding import sharded_global_norm

    specs = param_pspecs(cfg, policy)
    for g, v, spec in zip(grads["tables"], cfg.vocab_sizes, specs["tables"]):
        if spec[0] is not None:
            g[v // policy.size(spec[0]):].zero_()
    mlps = [t for name in ("bot", "top") for key in ("w", "b")
            for t in grads[name][key]]
    if policy.n_devices > 1:
        comm.all_reduce_grads(mlps, policy.group(policy.all_axes),
                              tag="grad_dp")
    return sharded_global_norm(grads, specs, policy)


@torch.inference_mode()
def forward(cfg: DLRMConfig, model, batch: dict, *,
            policy=None) -> torch.Tensor:
    """batch: dense (B, 13) f32, sparse (B, 26, hot) int32 -> logits (B,):
    :func:`logits` with no gradient.

    Under ``policy``, ``model`` is the rank's :class:`ShardedDLRM` and
    every rank passes the same batch: the embeddings are vocab-parallel,
    the interaction and top MLP data-parallel over every rank, and the
    rank gets its slice of the logits, ``B / n_devices`` rows at
    ``policy.coord(policy.all_axes)``."""
    if policy is None:
        return model(batch)
    return logits(model, batch, policy=policy)
