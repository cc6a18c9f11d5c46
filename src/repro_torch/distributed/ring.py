"""Ring SpMM: EnGN's ring-edge-reduce (RER) dataflow across devices.

EnGN aggregates by passing partial results around a physical ring of PEs
(the paper's ``aggregate`` term, M*(M-1)*T moved per pass, all of it on
the fast L1 fabric).  The multi-device analogue: node-feature shards
circulate a ring of ranks by point-to-point hops; at every hop each rank
aggregates the edges whose sources live in the resident shard into its
local destination accumulator.  Total wire volume equals one all-gather of
the feature matrix, but (a) no rank ever materializes the full matrix, and
(b) every hop overlaps with the local gather and segment sum.

Two execution paths share one semantics (the tests hold both to the plain
segment-sum oracle and to single-device autograd):

* :func:`allgather_spmm`: the paper-faithful baseline, all-gather every
  vertex's features (EnGN ``loadvertL2`` with no degree cache), then
  aggregate.
* :func:`ring_spmm`: the RER adaptation, hop-overlapped.  It makes n - 1
  hops; the reference's loop makes n, the last of which only carries the
  block home and is dropped, so the port's ledger equals
  ``ring_spmm_traffic`` exactly.

The per-rank functions take this rank's rows of ``h`` and its row of the
partition, and return its rows of the result; a rank's place in the ring
is its rank in ``group``.  Sums accumulate in float64, as the port's GNN
``segment_sum`` does.

Host-side :func:`partition_edges_ring` and :func:`partition_edges_gather`
build the static padded layouts (the paper's partitioning preprocessing,
Fig. 1), bit-identical to the reference's, with one stable sort where the
reference loops over the edges in Python.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.common import SEGMENT_SUM_CHUNK, segment_sum
from . import comm

__all__ = ["RingEdgePartition", "GatherEdgePartition",
           "partition_edges_ring", "partition_edges_gather",
           "allgather_spmm", "ring_spmm"]


# ---------------------------------------------------------------------------
# Host-side graph partitioning (pipeline preprocessing)
# ---------------------------------------------------------------------------

@dataclass
class RingEdgePartition:
    """Edges grouped by (dst shard, src block), padded to a static E_blk.

    Arrays are GLOBAL with leading dim n_shards (the dst shard); rank d
    takes row d.  ``senders`` are indices *within* the src block,
    ``receivers`` indices within the dst shard.  Padding entries have
    weight 0 (and index 0).
    """

    senders: np.ndarray     # (n_shards, n_shards, E_blk) int32
    receivers: np.ndarray   # (n_shards, n_shards, E_blk) int32
    weights: np.ndarray     # (n_shards, n_shards, E_blk) float32
    n_local: int            # nodes per shard
    pad_ratio: float        # padded / real edges (HyGCN's P_s analogue)


@dataclass
class GatherEdgePartition:
    """Edges grouped by dst shard only (baseline layout)."""

    senders: np.ndarray     # (n_shards, E_loc) int32, GLOBAL src index
    receivers: np.ndarray   # (n_shards, E_loc) int32, local dst index
    weights: np.ndarray     # (n_shards, E_loc) float32
    n_local: int
    pad_ratio: float


def _slots(key: np.ndarray, n_keys: int):
    """Edges in stable order of ``key``, each edge's rank among the earlier
    edges of its key, and the largest key count (at least 1): the fill
    order of the reference's loop."""
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_keys)
    starts = np.cumsum(counts) - counts
    sorted_key = key[order]
    k = np.arange(key.shape[0], dtype=np.int64) - starts[sorted_key]
    return order, sorted_key, k, max(int(counts.max()), 1)


def partition_edges_ring(senders: np.ndarray, receivers: np.ndarray,
                         weights: np.ndarray, n_nodes: int,
                         n_shards: int) -> RingEdgePartition:
    assert n_nodes % n_shards == 0, (n_nodes, n_shards)
    n_local = n_nodes // n_shards
    dst_shard = receivers // n_local
    src_block = senders // n_local
    order, key, k, e_blk = _slots(
        (dst_shard * n_shards + src_block).astype(np.int64),
        n_shards * n_shards)
    shape = (n_shards, n_shards, e_blk)
    snd = np.zeros(shape, np.int32)
    rcv = np.zeros(shape, np.int32)
    wgt = np.zeros(shape, np.float32)
    flat = key * e_blk + k
    snd.reshape(-1)[flat] = senders[order] - src_block[order] * n_local
    rcv.reshape(-1)[flat] = receivers[order] - dst_shard[order] * n_local
    wgt.reshape(-1)[flat] = weights[order]
    pad_ratio = (n_shards * n_shards * e_blk) / max(senders.shape[0], 1)
    return RingEdgePartition(snd, rcv, wgt, n_local, pad_ratio)


def partition_edges_gather(senders: np.ndarray, receivers: np.ndarray,
                           weights: np.ndarray, n_nodes: int,
                           n_shards: int) -> GatherEdgePartition:
    assert n_nodes % n_shards == 0
    n_local = n_nodes // n_shards
    dst_shard = receivers // n_local
    order, key, k, e_loc = _slots(dst_shard.astype(np.int64), n_shards)
    snd = np.zeros((n_shards, e_loc), np.int32)
    rcv = np.zeros((n_shards, e_loc), np.int32)
    wgt = np.zeros((n_shards, e_loc), np.float32)
    flat = key * e_loc + k
    snd.reshape(-1)[flat] = senders[order]
    rcv.reshape(-1)[flat] = receivers[order] - dst_shard[order] * n_local
    wgt.reshape(-1)[flat] = weights[order]
    pad_ratio = (n_shards * e_loc) / max(senders.shape[0], 1)
    return GatherEdgePartition(snd, rcv, wgt, n_local, pad_ratio)


# ---------------------------------------------------------------------------
# Device-side aggregation
# ---------------------------------------------------------------------------

def allgather_spmm(h: torch.Tensor, part_senders: torch.Tensor,
                   part_receivers: torch.Tensor, part_weights: torch.Tensor,
                   *, group) -> torch.Tensor:
    """Baseline 1D SpMM: all-gather features, local gather + segment-sum.

    h: this rank's (n_local, F) rows; the partition arrays: this rank's row
    (E_loc,) of a :class:`GatherEdgePartition`.  Returns this rank's
    (n_local, F) rows of A @ H.  Differentiable in ``h``.
    """
    h_full = comm.all_gather(h, group, 0)
    msgs = h_full[part_senders.long()] * part_weights[:, None]
    return segment_sum(msgs, part_receivers.long(), h.shape[0])


def _accumulate(acc: torch.Tensor, src: torch.Tensor, take: torch.Tensor,
                put: torch.Tensor, w: torch.Tensor) -> None:
    """``acc[put] += src[take] * w`` in ``acc``'s float64, a chunk of edges
    at a time (the messages in ``src``'s dtype, as ``segment_sum``)."""
    step = max(1, SEGMENT_SUM_CHUNK // max(1, src.shape[1]))
    for lo in range(0, take.shape[0], step):
        hi = lo + step
        acc.index_add_(0, put[lo:hi],
                       (src[take[lo:hi]] * w[lo:hi, None]).double())


class _RingSpMM(torch.autograd.Function):
    """Forward: n - 1 hops of the feature block to rank + 1, each started
    before the resident block's edges are summed.  Backward: the transpose,
    an accumulator per destination block travelling to rank - 1, each hop
    started after this rank adds its edges' part for that block (computed
    while the hop in flight lands)."""

    @staticmethod
    def forward(ctx, h, snd, rcv, wgt, group):
        n, r = comm.group_size(group), comm.group_rank(group)
        ctx.save_for_backward(snd, rcv, wgt)
        ctx.group = group
        acc = torch.zeros(h.shape, dtype=torch.float64, device=h.device)
        block = h
        for t in range(n):
            hop = comm.start_hop(block, group) if t < n - 1 else None
            b = (r - t) % n
            _accumulate(acc, block, snd[b], rcv[b], wgt[b])
            if hop is not None:
                block = hop.wait()
        return acc.to(h.dtype)

    @staticmethod
    def backward(ctx, grad):
        snd, rcv, wgt = ctx.saved_tensors
        group = ctx.group
        n, r = comm.group_size(group), comm.group_rank(group)
        hop, out = None, None
        for t in range(n):
            b = (r + t + 1) % n
            part = torch.zeros(grad.shape, dtype=torch.float64,
                               device=grad.device)
            _accumulate(part, grad, rcv[b], snd[b], wgt[b])
            if hop is not None:
                part += hop.wait().double()
            if t < n - 1:
                hop = comm.start_hop(part.to(grad.dtype), group, -1)
            else:
                out = part.to(grad.dtype)
        return out, None, None, None, None


def ring_spmm(h: torch.Tensor, part_senders: torch.Tensor,
              part_receivers: torch.Tensor, part_weights: torch.Tensor, *,
              group) -> torch.Tensor:
    """RER ring SpMM: feature shards circulate; each hop aggregates the
    resident src block's edges into the local dst accumulator.

    h: this rank's (n_local, F) rows; the partition arrays: this rank's
    (n_shards, E_blk) row of a :class:`RingEdgePartition`, indexed by src
    block.  Returns this rank's (n_local, F) rows of A @ H.
    Differentiable in ``h``.
    """
    return _RingSpMM.apply(h, part_senders.long(), part_receivers.long(),
                           part_weights, group)
