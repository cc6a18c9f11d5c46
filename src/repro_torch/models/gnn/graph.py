"""Graph batches: padded, fixed-shape edge lists (the reference's
``models/gnn/graph.py`` as a plain dataclass of tensors).

Graphs are padded to static shapes: masked edges carry zero weight and point
at any node, masked nodes contribute nothing to losses.  Batched small graphs
(the ``molecule`` shape) concatenate their nodes and edges and carry
``graph_ids`` for the per-graph readouts.

A batch may be built from NumPy arrays (the reference's int32 indices among
them); :meth:`GraphBatch.to` makes every field a tensor on one device and
widens the index fields to int64 once, which the gathers, ``index_add_`` and
``scatter_reduce_`` of the layers then take as they are.

Under a sharding policy each rank trains on a :class:`GraphShard`, its view
of the global batch (:func:`shard_graph`): a contiguous block of the padded
nodes, and every edge whose receiver it owns (the receiver-owned layout of
``distributed.ring.partition_edges_gather``), senders kept as global ids.
Every sum over a receiver's edges is then local.  A shard may also hold a
slice of a model's channels (2-D GNN partitioning: the ranks that share a
node block split the channels).  The models reach the other ranks only
through the batch's methods, which are identities on a ``GraphBatch``:
:meth:`GraphBatch.senders_table` (the node rows the edges read at their
senders), :meth:`~GraphBatch.node_total` (a readout summed over the node
ranks), :meth:`~GraphBatch.objective` (this rank's share of a loss every
rank computes alike), and over the channel ranks
:meth:`~GraphBatch.channels` (this rank's slice),
:meth:`~GraphBatch.channel_sum`, :meth:`~GraphBatch.channel_scatter` and
:meth:`~GraphBatch.channel_gather`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ...distributed import comm
from ...obs import SYM_NORM, span
from ..common import segment_sum

__all__ = ["GraphBatch", "GraphShard", "channel_split", "degrees",
           "sym_norm_coeffs", "shard_graph"]

#: Fields that index nodes or graphs: int64 after :meth:`GraphBatch.to`.
_INDEX_FIELDS = ("senders", "receivers", "graph_ids")
#: Fields with a row per edge; the other arrays have a row per node, or
#: (graph-level labels) none.
_EDGE_FIELDS = ("senders", "receivers", "edge_feat", "edge_mask", "wigner")


def _tensor(x: Any, dev: torch.device, *, index: bool) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(
        np.require(x, requirements="CW"))
    if index or not t.is_floating_point():
        t = t.long()
    return t.to(dev)


@dataclass
class GraphBatch:
    node_feat: Any                         # (N, F)
    senders: Any                           # (E,)
    receivers: Any                         # (E,)
    edge_feat: Optional[Any] = None        # (E, Fe)
    labels: Optional[Any] = None           # (N,) int or (n_graphs, ...) float
    node_mask: Optional[Any] = None        # (N,) float {0,1}
    edge_mask: Optional[Any] = None        # (E,) float {0,1}
    graph_ids: Optional[Any] = None        # (N,) molecule batching
    positions: Optional[Any] = None        # (N, 3), equivariant models
    wigner: Optional[dict] = None          # {l: (E, m_dim, 2l+1)} eSCN blocks
    n_graphs: int = 1

    #: Fields that are not arrays (kept as they are by :meth:`to`).
    _SCALARS = ("n_graphs",)

    def to(self, device=None) -> "GraphBatch":
        """Every field as a tensor on ``device`` (CUDA unless ``"cpu"``):
        index fields and integer labels int64, floats in their own dtype."""
        dev = resolve_device(device)
        kw: dict[str, Any] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None or f.name in self._SCALARS:
                continue
            if f.name == "wigner":
                kw[f.name] = {int(l): _tensor(w, dev, index=False)
                              for l, w in v.items()}
            else:
                kw[f.name] = _tensor(v, dev, index=f.name in _INDEX_FIELDS)
        return replace(self, **kw)

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def emask(self) -> torch.Tensor:
        if self.edge_mask is None:
            return torch.ones(self.n_edges, dtype=torch.float32,
                              device=self.senders.device)
        return self.edge_mask

    def nmask(self) -> torch.Tensor:
        if self.node_mask is None:
            return torch.ones(self.n_nodes, dtype=torch.float32,
                              device=self.node_feat.device)
        return self.node_mask

    # ---- the rank's view (identities on one device; see GraphShard) -------
    def senders_table(self, x: torch.Tensor) -> torch.Tensor:
        """The node rows that ``senders`` index, from this rank's rows
        ``x``: ``x`` itself, as a view whose backward collects the senders'
        reads before they join ``x``'s other gradients, in the order a
        shard's gathered table collects them."""
        return x.view_as(x)

    def node_total(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the nodes (a readout) totalled over the node ranks."""
        return x

    def objective(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's share of ``loss``, a value every rank computes
        alike: what its backward starts from."""
        return loss

    def channels(self, width: int) -> tuple[int, int]:
        """``(lo, hi)``: the slice of ``width`` channels (or hidden units)
        this rank holds, all of them here."""
        return 0, width

    def channel_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a per-node partial over this rank's channels, summed
        over the channel ranks."""
        return x

    def channel_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``, a per-node partial over this rank's channels, summed
        over the channel ranks: this rank's slice of ``dim``."""
        return x

    def channel_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The channel ranks' slices of ``dim`` put together, whole."""
        return x


@dataclass
class GraphShard(GraphBatch):
    """One rank's view of a global graph batch (:func:`shard_graph`).

    Node fields hold this rank's ``n_total / node_ranks`` rows of the
    padded nodes; edge fields its receivers' unmasked edges, padded to the
    largest rank's count with masked edges (``edge_ids`` -1).
    ``receivers`` are local row ids and ``senders`` global ones, into
    :meth:`senders_table`.  ``sym_norm`` holds each local edge's GCN
    coefficient from the global batch's degrees (a sender's degree is not
    local).  Graph-level labels stay whole.

    The collectives, each tagged for the ledger: :meth:`senders_table`
    all-gathers the rank's rows over ``node_group`` (``"gnn_gather"``;
    its backward reduce-scatters); :meth:`node_total` is a
    :func:`~repro_torch.distributed.comm.psum` over ``node_group``
    (``"gnn_readout"``), and :meth:`objective` divides by ``n_ranks``,
    every rank of the policy: the backward of the psums and the gathers
    sums the ranks' shares, so the gradient summed over the ranks is the
    single-device gradient.  Ranks outside ``node_group`` that hold the
    same node block (the ``model`` ranks of a 2-D model) compute alike,
    and the ``1 / n_ranks`` counts each of them once.

    With ``channel_ranks`` > 1 those ranks split the model's channels
    instead: this rank holds slice ``channel_rank`` of every channel axis
    (:meth:`channels`), and the per-node partials over its slice meet over
    ``channel_group`` (tagged ``"gnn_tp"``): :meth:`channel_sum` a
    :func:`~repro_torch.distributed.comm.psum`, :meth:`channel_scatter` a
    reduce-scatter (its backward an all-gather) and :meth:`channel_gather`
    an all-gather (its backward a reduce-scatter).  Each backward is its
    forward's adjoint, so a product a channel rank computes on its own
    slice and one every channel rank repeats alike both come out summed
    right over the ranks.
    """

    edge_ids: Any = None            # (E_loc,) global edge id, -1 on padding
    sym_norm: Any = None            # (E_loc,) GCN coefficients
    n_total: int = 0                # padded global node count
    node_group: Any = None
    n_ranks: int = 1
    channel_group: Any = None
    channel_ranks: int = 1
    channel_rank: int = 0

    _SCALARS = ("n_graphs", "n_total", "node_group", "n_ranks",
                "channel_group", "channel_ranks", "channel_rank")

    def senders_table(self, x):
        return comm.all_gather(x, self.node_group, 0, tag="gnn_gather")

    def node_total(self, x):
        return comm.psum(x, self.node_group, tag="gnn_readout")

    def objective(self, loss):
        return loss / self.n_ranks

    def channels(self, width):
        n = width // self.channel_ranks
        return self.channel_rank * n, (self.channel_rank + 1) * n

    def channel_sum(self, x):
        if self.channel_ranks == 1:
            return x
        return comm.psum(x, self.channel_group, tag="gnn_tp")

    def channel_scatter(self, x, dim):
        if self.channel_ranks == 1:
            return x
        return comm.reduce_scatter(x, self.channel_group, dim, tag="gnn_tp")

    def channel_gather(self, x, dim):
        if self.channel_ranks == 1:
            return x
        return comm.all_gather(x, self.channel_group, dim, tag="gnn_tp")


def channel_split(policy, axes) -> dict:
    """The :class:`GraphShard` fields of a channel split over ``axes`` of
    ``policy`` (none: whole channels)."""
    if axes is None or policy.size(axes) == 1:
        return {}
    return {"channel_group": policy.group(axes),
            "channel_ranks": policy.size(axes),
            "channel_rank": policy.coord(axes)}


def degrees(g: GraphBatch, *, direction: str = "in") -> torch.Tensor:
    idx = g.receivers if direction == "in" else g.senders
    return segment_sum(g.emask(), idx, g.n_nodes)


def sym_norm_coeffs(g: GraphBatch, *, eps: float = 1e-9) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt(d_i d_j) per edge (self-loops are
    expected to already be present as edges); a shard's, from the global
    batch's degrees, as its cut took them."""
    if isinstance(g, GraphShard):
        return g.sym_norm
    with span(SYM_NORM):
        deg_in = degrees(g, direction="in")
        deg_out = degrees(g, direction="out")
        inv_i = torch.rsqrt(torch.clamp_min(deg_in, eps))[g.receivers]
        inv_j = torch.rsqrt(torch.clamp_min(deg_out, eps))[g.senders]
        return inv_i * inv_j * g.emask()


def _rows(x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows ``lo`` to ``lo + n`` of ``x``, zero past its end."""
    out = x.new_zeros((n, *x.shape[1:]))
    k = max(0, min(n, x.shape[0] - lo))
    out[:k] = x[lo:lo + k]
    return out


def shard_graph(g: GraphBatch, specs: GraphBatch, policy, *,
                n_total: int, edge_chunks: int = 1,
                channel_axes=None) -> GraphShard:
    """This rank's :class:`GraphShard` of ``g``, a global batch of tensors
    that every rank passes alike, laid out by ``specs`` (the reference's
    ``_gnn_graph_specs``: a field whose spec names axes on its first dim
    is cut over them, the others stay whole).

    The nodes are padded to ``n_total`` (masked, zero) and cut into
    contiguous blocks over the node axes, at this rank's coordinate along
    them.  Each edge (a masked edge of the batch adds nothing anywhere and
    is dropped) goes to the rank that owns its receiver, in the order of
    the global batch, and every rank's edges are padded to the largest
    rank's count, rounded up to a multiple of the edge chunks, with
    masked, zero edges from global node 0 to local node 0: the layout of
    ``distributed.ring.partition_edges_gather`` over the unmasked edges.

    The chunks are ``edge_chunks`` for Wigner blocks that come whole,
    (E, m_dim, 2l+1), and the blocks' own for pre-chunked ones, (n_chunks,
    Ec, m_dim, 2l+1) with their spec on the edge dim: those are flattened
    in the global edge order, cut as every other edge field, and chunked
    again over the rank's edges.  With ``channel_axes`` the ranks along
    them (which share the node block) split the model's channels
    (:func:`channel_split`).  Raises when ``n_total`` does not split over
    the node ranks."""
    axes = specs.node_feat[0]
    n, r = policy.size(axes), policy.coord(axes)
    if n_total < g.n_nodes or n_total % n:
        raise ValueError(f"{g.n_nodes} nodes padded to {n_total} do not "
                         f"split over {n} node ranks ({axes})")
    chunks = max(edge_chunks, 1)
    pre_chunked = (g.wigner is not None
                   and next(iter(g.wigner.values())).dim() == 4)
    if pre_chunked:
        chunks = next(iter(g.wigner.values())).shape[0]
        g = replace(g, wigner={l: w.reshape(-1, *w.shape[2:])
                               for l, w in g.wigner.items()})
    n_loc = n_total // n
    lo = r * n_loc
    owner = torch.div(g.receivers, n_loc, rounding_mode="floor")
    real = g.emask() > 0
    e_loc = max(int(torch.bincount(owner[real], minlength=n).max()), 1)
    e_loc = -(-e_loc // chunks) * chunks
    ids = torch.nonzero((owner == r) & real).squeeze(1)
    pad = e_loc - ids.numel()

    def edges(x):
        x = x[ids]
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    kw: dict[str, Any] = {}
    for f in fields(GraphBatch):
        v = getattr(g, f.name)
        spec = getattr(specs, f.name)
        if f.name == "n_graphs" or v is None:
            continue
        if f.name == "wigner":
            spec = next(iter(spec.values()))
            if pre_chunked:
                spec = spec[1:]
        split = bool(spec) and spec[0] is not None
        if not split:
            kw[f.name] = v
        elif f.name == "wigner":
            kw[f.name] = {l: edges(w) for l, w in v.items()}
            if pre_chunked:
                kw[f.name] = {l: w.reshape(chunks, -1, *w.shape[1:])
                              for l, w in kw[f.name].items()}
        elif f.name in _EDGE_FIELDS:
            kw[f.name] = edges(v)
        else:
            kw[f.name] = _rows(v, lo, n_loc)
    kw["receivers"] = edges(g.receivers - lo)
    kw["edge_mask"] = edges(g.emask())
    kw["node_mask"] = _rows(g.nmask(), lo, n_loc)
    return GraphShard(
        **kw, n_graphs=g.n_graphs,
        edge_ids=torch.cat([ids, ids.new_full((pad,), -1)]),
        sym_norm=edges(sym_norm_coeffs(g)), n_total=n_total,
        node_group=policy.group(axes), n_ranks=policy.n_devices,
        **channel_split(policy, channel_axes))
