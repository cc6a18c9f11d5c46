"""Deterministic generators for the trace path, DLRM and training (a copy
of the reference's ``repro/data/synthetic.py``: the graphs, ``lm_batch``
and ``criteo_batch``).

Every generator is a pure function of its seed and parameters.  The random
streams are the reference's, call for call, so the port and the reference
draw bit-identical edge lists and Criteo batches from the same arguments
(pinned in ``tests/test_torch_trace.py`` and ``tests/test_torch_dlrm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["lm_batch", "power_law_graph", "power_law_edge_stream", "power_law_edges",
           "power_law_stream_blocks", "ring_of_tiles_graph",
           "molecule_batch", "criteo_batch", "GraphArrays",
           "POWER_LAW_STREAM_CHUNK"]


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch(seed: int, step: int, *, batch: int, seq: int,
             vocab: int) -> dict[str, np.ndarray]:
    """Zipfian token stream (vocabulary rank-frequency like real text):
    int32 ``tokens`` (B, S) and next-token ``labels`` (B, S)."""
    r = _rng(seed, step)
    toks = r.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = np.minimum(toks - 1, vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class GraphArrays:
    senders: np.ndarray
    receivers: np.ndarray
    node_feat: np.ndarray
    labels: np.ndarray
    edge_weight: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]


def power_law_graph(seed: int, *, n_nodes: int, n_edges: int, d_feat: int,
                    n_classes: int = 7, alpha: float = 1.6,
                    self_loops: bool = True) -> GraphArrays:
    """Preferential-attachment-flavoured random graph: destination degrees
    follow a power law (the workload imbalance the paper highlights)."""
    if n_nodes < 2 and n_edges > 0:
        raise ValueError(
            f"power_law_graph needs n_nodes >= 2 to draw self-loop-free "
            f"edges (got n_nodes={n_nodes}, n_edges={n_edges})")
    r = _rng(seed, 0)
    # power-law weights over nodes for choosing edge endpoints
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    perm = r.permutation(n_nodes)
    senders = perm[r.choice(n_nodes, size=n_edges, p=w)]
    receivers = perm[r.choice(n_nodes, size=n_edges, p=w)]
    # No self loops: a clashing receiver is re-drawn as sender + a uniform
    # offset in [1, n_nodes), which can never land back on the sender.
    clash = senders == receivers
    if np.any(clash):
        offsets = r.integers(1, n_nodes, size=int(clash.sum()))
        receivers[clash] = (senders[clash] + offsets) % n_nodes
    if self_loops:
        senders = np.concatenate([senders, np.arange(n_nodes)])
        receivers = np.concatenate([receivers, np.arange(n_nodes)])
    feat = r.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = r.integers(0, n_classes, n_nodes).astype(np.int32)
    return GraphArrays(senders.astype(np.int32), receivers.astype(np.int32),
                       feat, labels)


#: Edges per *generation block* of the streaming power-law generator.  The
#: rng is re-seeded per block index, so the edge list is a pure function of
#: (seed, params) alone; ``chunk_edges`` only sets emission granularity.
#: Changing this constant changes every streamed graph.
POWER_LAW_STREAM_CHUNK = 1 << 20


def _power_law_stream_setup(seed: int, n_nodes: int, alpha: float):
    """(cdf, perm) shared by every block of one stream."""
    w = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-float(alpha))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    perm = _rng(seed, 0).permutation(n_nodes)
    return cdf, perm


def _power_law_block(seed: int, block_index: int, m: int, cdf, perm,
                     n_nodes: int):
    """Block ``block_index`` of the stream: ``m`` edges from its own rng."""
    r = _rng(seed, block_index + 1)
    snd_rank = np.searchsorted(cdf, r.random(m), side="right")
    rcv_rank = np.searchsorted(cdf, r.random(m), side="right")
    # float roundoff can push a draw past cdf[-1]; clamp to the last rank
    np.minimum(snd_rank, n_nodes - 1, out=snd_rank)
    np.minimum(rcv_rank, n_nodes - 1, out=rcv_rank)
    snd = perm[snd_rank].astype(np.int64, copy=False)
    rcv = perm[rcv_rank].astype(np.int64, copy=False)
    clash = snd == rcv
    if np.any(clash):
        # same de-clash as power_law_graph
        offsets = r.integers(1, n_nodes, size=int(clash.sum()))
        rcv[clash] = (snd[clash] + offsets) % n_nodes
    return snd, rcv


def power_law_stream_blocks(n_edges: int) -> int:
    """Number of fixed-size generation blocks in an ``n_edges`` stream."""
    n_edges = int(n_edges)
    return -(-n_edges // POWER_LAW_STREAM_CHUNK) if n_edges > 0 else 0


def power_law_edge_stream(seed: int, *, n_nodes: int, n_edges: int,
                          alpha: float = 1.6,
                          chunk_edges: int = POWER_LAW_STREAM_CHUNK,
                          shard: int = 0, n_shards: int = 1):
    """Chunk-streamed power-law edge generator for >= 10^6-edge graphs.

    Yields ``(senders, receivers)`` int64 chunks of at most ``chunk_edges``
    edges with the contract of :func:`power_law_graph` (power-law degrees
    over a permuted rank order, no self loops) in O(block + n_nodes) peak
    memory: endpoints are drawn by inverse-CDF ``searchsorted``.  The
    concatenated list is invariant to ``chunk_edges`` and to how the blocks
    are divided among shards (``block_index % n_shards == shard``).
    """
    n_nodes = int(n_nodes)
    n_edges = int(n_edges)
    chunk_edges = int(chunk_edges)
    shard = int(shard)
    n_shards = int(n_shards)
    if n_edges < 0 or chunk_edges < 1:
        raise ValueError(f"need n_edges >= 0 and chunk_edges >= 1, got "
                         f"n_edges={n_edges}, chunk_edges={chunk_edges}")
    if n_shards < 1 or not 0 <= shard < n_shards:
        raise ValueError(f"need 0 <= shard < n_shards, got shard={shard}, "
                         f"n_shards={n_shards}")
    if n_nodes < 2 and n_edges > 0:
        raise ValueError(
            f"power_law_edge_stream needs n_nodes >= 2 to draw "
            f"self-loop-free edges (got n_nodes={n_nodes}, "
            f"n_edges={n_edges})")
    cdf, perm = _power_law_stream_setup(seed, n_nodes, alpha)
    B = POWER_LAW_STREAM_CHUNK
    n_blocks = power_law_stream_blocks(n_edges)
    pending: list[tuple[np.ndarray, np.ndarray]] = []
    buffered = 0
    for b in range(shard, n_blocks, n_shards):
        m = min(B, n_edges - b * B)
        snd, rcv = _power_law_block(seed, b, m, cdf, perm, n_nodes)
        pending.append((snd, rcv))
        buffered += m
        while buffered >= chunk_edges:
            # emit exactly chunk_edges from the buffered block slices
            if len(pending) == 1 and pending[0][0].size == chunk_edges:
                (out,) = pending
                pending = []
            else:
                snd_c = np.concatenate([p[0] for p in pending])
                rcv_c = np.concatenate([p[1] for p in pending])
                out = (snd_c[:chunk_edges], rcv_c[:chunk_edges])
                tail = (snd_c[chunk_edges:], rcv_c[chunk_edges:])
                pending = [tail] if tail[0].size else []
            buffered -= chunk_edges
            yield out
    if buffered:
        if len(pending) == 1:
            yield pending[0]
        else:
            yield (np.concatenate([p[0] for p in pending]),
                   np.concatenate([p[1] for p in pending]))


def power_law_edges(seed: int, *, n_nodes: int, n_edges: int,
                    alpha: float = 1.6,
                    chunk_edges: int = POWER_LAW_STREAM_CHUNK,
                    shard: int = 0, n_shards: int = 1,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Materialize :func:`power_law_edge_stream` into compact arrays.

    Senders/receivers come back in the narrowest integer dtype that holds
    the vertex ids (int32 below 2^31 vertices), filled chunk by chunk into
    preallocated arrays.
    """
    n_edges = int(n_edges)
    dtype = (np.int32 if int(n_nodes) <= np.iinfo(np.int32).max
             else np.int64)
    B = POWER_LAW_STREAM_CHUNK
    owned = sum(min(B, n_edges - b * B)
                for b in range(int(shard), power_law_stream_blocks(n_edges),
                               int(n_shards)))
    senders = np.empty(owned, dtype=dtype)
    receivers = np.empty(owned, dtype=dtype)
    at = 0
    for snd, rcv in power_law_edge_stream(seed, n_nodes=n_nodes,
                                          n_edges=n_edges, alpha=alpha,
                                          chunk_edges=chunk_edges,
                                          shard=shard, n_shards=n_shards):
        senders[at:at + snd.size] = snd
        receivers[at:at + rcv.size] = rcv
        at += snd.size
    return senders, receivers


def ring_of_tiles_graph(*, n_nodes: int, n_tiles: int,
                        d_feat: int = 1) -> GraphArrays:
    """Perfectly uniform ring-of-tiles graph, on which the composition
    layer's uniform-tile approximation is exact.

    With ``K = n_nodes / n_tiles``, every vertex receives one local ring
    edge (its in-tile predecessor) plus one edge from the vertex ``t * K``
    behind it for every ``t in 1..n_tiles-1``: exactly one source in every
    other tile, all remote sources distinct.  Deterministic; no self loops
    (needs ``K >= 2``).
    """
    if n_tiles < 1 or n_nodes % n_tiles:
        raise ValueError(f"n_tiles must divide n_nodes for a uniform ring "
                         f"(got n_nodes={n_nodes}, n_tiles={n_tiles})")
    K = n_nodes // n_tiles
    if K < 2:
        raise ValueError(f"ring_of_tiles_graph needs >= 2 vertices per tile "
                         f"to avoid self loops (got {K})")
    i = np.arange(n_nodes, dtype=np.int64)
    tile = i // K
    local_src = (i - tile * K - 1) % K + tile * K   # in-tile ring predecessor
    senders = [local_src]
    receivers = [i]
    for t in range(1, n_tiles):
        senders.append((i - t * K) % n_nodes)       # one source per other tile
        receivers.append(i)
    snd = np.concatenate(senders).astype(np.int32)
    rcv = np.concatenate(receivers).astype(np.int32)
    feat = np.ones((n_nodes, d_feat), np.float32)
    labels = np.zeros(n_nodes, np.int32)
    return GraphArrays(snd, rcv, feat, labels)


def criteo_batch(seed: int, step: int, *, batch: int, n_dense: int,
                 vocab_sizes: tuple[int, ...], multi_hot: int = 1,
                 zipf: float = 1.2) -> dict[str, np.ndarray]:
    """Criteo-like batch: log-normal dense features, Zipfian categorical ids
    clamped at ``v - 1`` (hot rows dominate), int32 ids, and labels that
    correlate with the first dense feature."""
    r = _rng(seed, step)
    dense = r.lognormal(0.0, 1.0, (batch, n_dense)).astype(np.float32)
    dense = np.log1p(dense)
    sparse = np.zeros((batch, len(vocab_sizes), multi_hot), np.int64)
    for t, v in enumerate(vocab_sizes):
        raw = r.zipf(zipf, size=(batch, multi_hot))
        sparse[:, t, :] = np.minimum(raw - 1, v - 1)
    p = 1.0 / (1.0 + np.exp(2.5 - dense[:, 0]))
    labels = (r.random(batch) < p).astype(np.int32)
    return {"dense": dense, "sparse": sparse.astype(np.int32),
            "labels": labels}


def molecule_batch(seed: int, step: int, *, batch: int, n_nodes: int,
                   n_edges: int, d_feat: int) -> dict[str, np.ndarray]:
    """Batched random 3D molecules (positions + kNN-ish edges, no self
    loops); graph-level scalar target = a smooth function of geometry."""
    r = _rng(seed, step)
    pos = r.standard_normal((batch, n_nodes, 3)).astype(np.float64)
    snd = np.zeros((batch, n_edges), np.int64)
    rcv = np.zeros((batch, n_edges), np.int64)
    for b in range(batch):
        s = r.integers(0, n_nodes, n_edges)
        d = (s + 1 + r.integers(0, n_nodes - 1, n_edges)) % n_nodes
        snd[b], rcv[b] = s, d
    feat = r.standard_normal((batch, n_nodes, d_feat)).astype(np.float32)
    # invariant target: mean pairwise distance per graph
    tgt = np.stack([np.linalg.norm(pos[b][snd[b]] - pos[b][rcv[b]], axis=-1).mean()
                    for b in range(batch)]).astype(np.float32)
    return {"positions": pos, "senders": snd.astype(np.int32),
            "receivers": rcv.astype(np.int32), "node_feat": feat,
            "labels": tgt[:, None]}
