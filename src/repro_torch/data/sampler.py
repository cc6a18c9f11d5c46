"""k-hop fanout neighbor sampling (GraphSAGE-style) over a CSR adjacency,
as the minibatch workload generator of the movement model (a copy of the
episode part of the reference's ``repro/data/sampler.py``, NumPy only).

:func:`minibatch_schedule` runs ``n_batches`` independent sampling
episodes and returns a :class:`~repro_torch.core.trace.TraceSchedule`
whose "tiles" are episodes: ``vertex_counts`` the seed batch,
``edge_counts`` the sampled message edges, and ``halo_counts`` the exact
number of **unique non-seed** source vertices each episode gathers (the
neighbor-sampling gather traffic).  ``TiledGraphModel(schedule=...)`` then
charges the episodes with the same closed forms as any trace schedule.  A
brute-force ``np.unique`` oracle (:func:`minibatch_oracle_counts`)
recomputes every count through an independent code path.

Random protocol: episode ``b`` of ``seed`` uses
``np.random.default_rng(np.random.SeedSequence([seed, b]))``, draws the
seed batch with ``rng.choice(n_nodes, size=batch_nodes, replace=False)``,
then samples hops via :func:`_sample_edge_stream`: one
``rng.choice(deg, size=take, replace=False)`` call per frontier node with
nonzero in-degree, in frontier order.  The streams are the reference's,
call for call, so episode counts are bit-identical to its.

The training half: :func:`sample_subgraph` consumes the identical call
sequence and emits a padded :class:`SampledSubgraph` with static shapes
(the padded sizes of ``repro_torch.launch.steps.sampled_subgraph_sizes``,
so one step serves every sampled batch); it is bit-identical, array for
array, to the reference's and to :func:`_sample_subgraph_reference`, the
per-pick implementation kept as its regression pin.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.trace import TraceSchedule

__all__ = [
    "CSRGraph",
    "build_csr",
    "csr_from_trace",
    "sample_subgraph",
    "SampledSubgraph",
    "minibatch_schedule",
    "minibatch_oracle_counts",
]

_INT32_MAX = np.iinfo(np.int32).max


@dataclass
class CSRGraph:
    """In-neighbor CSR: for node v, neighbors are col[ptr[v]:ptr[v+1]]."""

    ptr: np.ndarray
    col: np.ndarray
    n_nodes: int


def build_csr(senders: np.ndarray, receivers: np.ndarray,
              n_nodes: int) -> CSRGraph:
    """Build the in-neighbor CSR from a (senders, receivers) edge list.

    ``col`` is stored int32 for footprint; ``n_nodes`` (and hence every
    stored sender id) must fit int32 — validated up front rather than
    silently wrapped by the narrowing cast.  Graphs beyond 2^31 - 1
    vertices belong to the int64 trace pipeline (``repro_torch.core.trace``).
    """
    n_nodes = int(n_nodes)
    if n_nodes < 0:
        raise ValueError(f"n_nodes must be non-negative, got {n_nodes}")
    if n_nodes > _INT32_MAX:
        raise ValueError(
            f"build_csr stores neighbor columns as int32, so n_nodes must "
            f"be <= {_INT32_MAX} (got {n_nodes}); use the int64 trace "
            "pipeline (repro_torch.core.trace) for larger graphs")
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ValueError("senders/receivers must be equal-length 1-D arrays")
    if senders.size:
        if int(senders.min()) < 0 or int(senders.max()) >= n_nodes:
            raise ValueError(f"sender ids must lie in [0, {n_nodes})")
        if int(receivers.min()) < 0 or int(receivers.max()) >= n_nodes:
            raise ValueError(f"receiver ids must lie in [0, {n_nodes})")
    order = np.argsort(receivers, kind="stable")
    col = senders[order].astype(np.int32)
    counts = np.bincount(receivers, minlength=n_nodes)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return CSRGraph(ptr=ptr, col=col, n_nodes=n_nodes)


def csr_from_trace(trace) -> CSRGraph:
    """View a (typed or plain) GraphTrace's destination-major factorization
    as a sampler CSR — no re-sort, no int32 narrowing (trace ids are kept
    in the trace's own dtype; within a row, neighbors are sender-sorted
    instead of stream-ordered, which uniform sampling is insensitive to).
    """
    return CSRGraph(ptr=np.asarray(trace.row_ptr, dtype=np.int64),
                    col=np.asarray(trace.csr_senders),
                    n_nodes=int(trace.n_nodes))


@dataclass
class SampledSubgraph:
    """Padded sampled subgraph with LOCAL node ids (0..n_sub)."""

    node_ids: np.ndarray       # (N_pad,) global ids (0-padded)
    senders: np.ndarray        # (E_pad,) local ids
    receivers: np.ndarray      # (E_pad,) local ids
    node_mask: np.ndarray      # (N_pad,) float {0,1}
    edge_mask: np.ndarray      # (E_pad,) float {0,1}
    seed_mask: np.ndarray      # (N_pad,) float: the loss is over the seeds
    n_real_nodes: int
    n_real_edges: int


def _sample_edge_stream(g: CSRGraph, seeds: np.ndarray,
                        fanout: tuple[int, ...],
                        rng: np.random.Generator
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Sampled message edges as GLOBAL-id streams (senders, receivers).

    The shared core of :func:`sample_subgraph` and
    :func:`minibatch_schedule`.  Only the per-node
    ``rng.choice(deg, size=take, replace=False)`` draws stay in a Python
    loop — they are an inherently sequential rng-stream protocol — and
    they are issued in exactly the frontier order of the original
    implementation (zero-degree nodes skipped), so the produced stream is
    bit-identical to the per-node-append version under the same rng.
    The next frontier is the pick stream itself, duplicates included.
    """
    snd_parts: list[np.ndarray] = []
    rcv_parts: list[np.ndarray] = []
    col = g.col
    frontier = np.asarray(seeds, dtype=np.int64)
    for f in fanout:
        lo = g.ptr[frontier]
        deg = g.ptr[frontier + 1] - lo
        keep = deg > 0
        v_k = frontier[keep]
        lo_k = lo[keep]
        take_k = np.minimum(int(f), deg[keep])
        offs = [rng.choice(int(d), size=int(t), replace=False)
                for d, t in zip(deg[keep].tolist(), take_k.tolist())]
        if offs:
            off = np.concatenate([np.asarray(o, dtype=np.int64)
                                  for o in offs])
        else:
            off = np.zeros(0, dtype=np.int64)
        picks = np.asarray(col[np.repeat(lo_k, take_k) + off],
                           dtype=np.int64)
        snd_parts.append(picks)
        rcv_parts.append(np.repeat(v_k, take_k))
        frontier = picks
    if not snd_parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    return np.concatenate(snd_parts), np.concatenate(rcv_parts)


# ---------------------------------------------------------------------------
# Sampled-minibatch episodes as a trace schedule
# ---------------------------------------------------------------------------


def _check_padding(n_real: int, e_real: int, n_pad: int, e_pad: int) -> None:
    if n_real > n_pad or e_real > e_pad:
        raise ValueError(f"sample exceeds padding: nodes {n_real}>{n_pad} "
                         f"or edges {e_real}>{e_pad}")


def _padded(ids_real, snd_real, rcv_real, n_seeds: int, n_pad: int,
            e_pad: int) -> SampledSubgraph:
    n_real, e_real = len(ids_real), len(snd_real)
    ids = np.zeros(n_pad, np.int32)
    ids[:n_real] = ids_real
    snd = np.zeros(e_pad, np.int32)
    snd[:e_real] = snd_real
    rcv = np.zeros(e_pad, np.int32)
    rcv[:e_real] = rcv_real
    nmask = np.zeros(n_pad, np.float32)
    nmask[:n_real] = 1.0
    emask = np.zeros(e_pad, np.float32)
    emask[:e_real] = 1.0
    smask = np.zeros(n_pad, np.float32)
    smask[:n_seeds] = 1.0
    return SampledSubgraph(ids, snd, rcv, nmask, emask, smask, n_real,
                           e_real)


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanout: tuple[int, ...],
                    *, rng: np.random.Generator, n_pad: int,
                    e_pad: int) -> SampledSubgraph:
    """Vectorized sampler: one edge-stream pass plus an O(V + E) remap.

    Bit-identical to :func:`_sample_subgraph_reference` under the same
    rng: local ids are assigned in first-appearance order over the
    concatenated pick stream (seeds first), which is exactly the discovery
    order of the per-pick dict insert.  ``seeds`` must be duplicate-free
    (they are drawn without replacement).
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    snd_g, rcv_g = _sample_edge_stream(g, seeds, fanout, rng)
    loc = np.full(g.n_nodes, -1, dtype=np.int64)
    loc[seeds] = np.arange(seeds.size)
    uniq, first = np.unique(snd_g, return_index=True)
    new_mask = loc[uniq] < 0
    new_vals = uniq[new_mask][np.argsort(first[new_mask])]
    loc[new_vals] = seeds.size + np.arange(new_vals.size)
    _check_padding(int(seeds.size + new_vals.size), int(snd_g.size), n_pad,
                   e_pad)
    return _padded(np.concatenate([seeds, new_vals]), loc[snd_g],
                   loc[rcv_g], seeds.size, n_pad, e_pad)


def _sample_subgraph_reference(g: CSRGraph, seeds: np.ndarray,
                               fanout: tuple[int, ...],
                               *, rng: np.random.Generator, n_pad: int,
                               e_pad: int) -> SampledSubgraph:
    """The per-pick implementation, kept as the bit-identity regression
    pin for :func:`sample_subgraph`: a dict of local ids filled in
    discovery order, one ``rng.choice`` per frontier node."""
    node_ids: list[int] = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    snd_l: list[int] = []
    rcv_l: list[int] = []
    frontier = list(seeds)
    for f in fanout:
        nxt: list[int] = []
        for v in frontier:
            lo, hi = g.ptr[v], g.ptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, int(deg))
            picks = g.col[lo + rng.choice(deg, size=take, replace=False)]
            for u in picks:
                u = int(u)
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                snd_l.append(local[u])
                rcv_l.append(local[int(v)])
                nxt.append(u)
        frontier = nxt
    _check_padding(len(node_ids), len(snd_l), n_pad, e_pad)
    return _padded(node_ids, snd_l, rcv_l, len(seeds), n_pad, e_pad)


def _episode_stream(g: CSRGraph, *, batch_nodes: int,
                    fanout: tuple[int, ...], episode: int,
                    seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(seeds, senders, receivers) of one sampling episode."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(episode)]))
    seeds = rng.choice(g.n_nodes, size=int(batch_nodes), replace=False)
    seeds = np.asarray(seeds, dtype=np.int64)
    snd, rcv = _sample_edge_stream(g, seeds, tuple(fanout), rng)
    return seeds, snd, rcv


def _validate_minibatch_args(g: CSRGraph, batch_nodes: int,
                             fanout, n_batches: int) -> tuple[int, ...]:
    fanout = tuple(int(f) for f in fanout)
    if not fanout or any(f < 1 for f in fanout):
        raise ValueError(f"fanout must be a non-empty tuple of >= 1 "
                         f"neighbor budgets, got {fanout!r}")
    if not (1 <= int(batch_nodes) <= g.n_nodes):
        raise ValueError(f"batch_nodes must lie in [1, n_nodes={g.n_nodes}], "
                         f"got {batch_nodes}")
    if int(n_batches) < 1:
        raise ValueError(f"n_batches must be >= 1, got {n_batches}")
    return fanout


def minibatch_schedule(g: CSRGraph, *, batch_nodes: int,
                       fanout, n_batches: int,
                       seed: int = 0) -> TraceSchedule:
    """Measure ``n_batches`` sampling episodes as an exact TraceSchedule.

    Episode ``b`` draws ``batch_nodes`` seed vertices without replacement
    and samples a ``fanout``-bounded k-hop in-neighborhood.  Schedule
    semantics mirror the graph-tiling trace exactly:

    * ``vertex_counts[b]`` — owned vertices: the seed batch,
    * ``edge_counts[b]`` — sampled message edges of the episode,
    * ``halo_counts[b]`` — **unique non-seed** source vertices gathered
      (the deduplicated neighbor-sampling gather the paper's halo-reload
      term charges at the halo feature width),
    * ``remote_edge_counts[b]`` — sampled edges whose source is not a
      seed (pre-dedup; ``halo <= remote`` as for tiles).

    The fast counting path marks V-sized boolean scratch arrays; the
    independent :func:`minibatch_oracle_counts` recomputes everything
    with ``np.unique`` / ``np.isin`` for the drift gate.  The schedule
    carries a ``(episode, source)`` multiplicity source, so
    ``cache_hit_fraction`` works for episodes too.  Results are cached
    per graph instance under the full parameter key.
    """
    fanout = _validate_minibatch_args(g, batch_nodes, fanout, n_batches)
    key = (int(batch_nodes), fanout, int(n_batches), int(seed))
    cache = getattr(g, "_episode_cache", None)
    if cache is None:
        cache = {}
        g._episode_cache = cache
    if key in cache:
        return cache[key]
    n_batches = int(n_batches)
    edge_counts = np.zeros(n_batches, dtype=np.float64)
    halo_counts = np.zeros(n_batches, dtype=np.float64)
    remote_counts = np.zeros(n_batches, dtype=np.float64)
    pair_tiles: list[np.ndarray] = []
    pair_counts: list[np.ndarray] = []
    is_seed = np.zeros(g.n_nodes, dtype=bool)
    seen = np.zeros(g.n_nodes, dtype=bool)
    for b in range(n_batches):
        seeds, snd, _ = _episode_stream(
            g, batch_nodes=batch_nodes, fanout=fanout, episode=b, seed=seed)
        is_seed[seeds] = True
        nonseed = snd[~is_seed[snd]]
        seen[nonseed] = True
        edge_counts[b] = snd.size
        remote_counts[b] = nonseed.size
        halo_counts[b] = np.count_nonzero(seen)
        # reset scratch in O(touched), not O(V)
        seen[nonseed] = False
        is_seed[seeds] = False
        src, cnt = np.unique(snd, return_counts=True)
        pair_tiles.append(np.full(src.size, b, dtype=np.int64))
        pair_counts.append(cnt.astype(np.int64))

    def _pairs() -> tuple[np.ndarray, np.ndarray]:
        if not pair_tiles:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        return np.concatenate(pair_tiles), np.concatenate(pair_counts)

    sched = TraceSchedule(
        n_tiles=n_batches, capacity=int(batch_nodes), K=int(batch_nodes),
        vertex_counts=np.full(n_batches, float(batch_nodes)),
        edge_counts=edge_counts, halo_counts=halo_counts,
        remote_edge_counts=remote_counts, _pair_source=_pairs)
    cache[key] = sched
    return sched


def minibatch_oracle_counts(g: CSRGraph, *, batch_nodes: int,
                            fanout, n_batches: int,
                            seed: int = 0) -> dict[str, np.ndarray]:
    """Brute-force ``np.unique`` oracle for :func:`minibatch_schedule`.

    Replays the identical episode rng protocol but counts through an
    independent path: per-episode gather/halo is
    ``np.setdiff1d(senders, seeds).size`` and remote edges are
    ``(~np.isin(senders, seeds)).sum()`` — no mark arrays shared with the
    fast path.
    """
    fanout = _validate_minibatch_args(g, batch_nodes, fanout, n_batches)
    n_batches = int(n_batches)
    edge_counts = np.zeros(n_batches, dtype=np.float64)
    halo_counts = np.zeros(n_batches, dtype=np.float64)
    remote_counts = np.zeros(n_batches, dtype=np.float64)
    for b in range(n_batches):
        seeds, snd, _ = _episode_stream(
            g, batch_nodes=batch_nodes, fanout=fanout, episode=b, seed=seed)
        edge_counts[b] = snd.size
        halo_counts[b] = np.setdiff1d(snd, seeds).size
        remote_counts[b] = int(np.sum(~np.isin(snd, seeds)))
    return {"edge_counts": edge_counts, "halo_counts": halo_counts,
            "remote_edge_counts": remote_counts}
