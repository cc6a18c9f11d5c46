"""The sharded trace pipeline: exact trace schedules of 10^8-edge graphs
(a copy of the reference's ``repro/distributed/trace_shard.py``, NumPy over a
thread pool).

The single-host trace path (:mod:`repro_torch.core.trace`) generates the
whole edge list, sorts it once by composite ``sender * V + receiver`` keys
and collapses it to the unique ``(sender, receiver)`` pairs that every tile
capacity shares.  Each of those stages is one host array as large as the
edge list.  This module shards all three, and its result is **bit-identical**
(values, order, dtypes) to the single-host path for every shard count:

1. **Generation.**  The streaming generator (:func:`repro_torch.data.
   synthetic.power_law_edge_stream`) draws edges in fixed blocks, each from
   its own ``(seed, block_index)`` rng, so shard ``s`` of ``S`` draws the
   blocks ``block_index % S == s`` on its own; the union over shards is the
   single stream, and no host holds the full edge list.

2. **Sort and factorization (a sample sort).**  Each shard folds its edges
   into composite keys and sorts them in place.  Splitters cut from regular
   samples of every sorted shard define ``S`` half-open key ranges; each
   shard splits its run against them by ``searchsorted`` and the pieces are
   exchanged (the all-to-all).  The ranges are disjoint and cover the key
   space, so all copies of a key meet in one bucket, and a merge plus a
   boundary-flag dedup per bucket gives, in bucket order, the globally
   sorted unique-pair factorization.

3. **CSR and per-capacity counts.**  The CSR row pointer is an O(U) sum over
   the factorization (:meth:`GraphTrace.from_factorization`); the E-sized
   receiver-major sort never happens.  Per-capacity halo and cut counts
   split the factorization at new-sender boundaries (no deduplicated
   ``(dst_tile, source)`` run crosses one), run the boundary-flag pass per
   chunk and sum the integer partial counts (:func:`sharded_schedule_counts`,
   the trace engine ``"sharded"``).

Shards run on a thread pool (NumPy's sort and searchsorted release the GIL)
sized by :func:`default_shard_count`: ``REPRO_TORCH_TRACE_SHARDS`` if set,
else the host's CPU count.  The shard count is an execution detail, never
identity: it enters no cache key, and the drift gate
(:func:`factorization_drift`) holds every shard count to the single-host
factorization.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..data import synthetic

__all__ = [
    "default_shard_count",
    "sharded_power_law_factorization",
    "build_power_law_trace",
    "sharded_schedule_counts",
    "typed_sharded_schedule_counts",
    "factorization_drift",
]

#: Largest vertex count whose composite ``sender * V + receiver`` keys fit
#: int64 (the same bound the single-host factorization uses before falling
#: back to lexsort).
MAX_KEY_NODES = int((2**63 - 1) ** 0.5)

#: Regular samples taken per shard per splitter when choosing bucket
#: boundaries.  Oversampling keeps bucket sizes within a small factor of
#: E/S even on skewed (power-law) key distributions.
_SPLITTER_OVERSAMPLE = 64


def default_shard_count() -> int:
    """Shard count: ``REPRO_TORCH_TRACE_SHARDS`` if set, else the host's CPU
    count."""
    raw = os.environ.get("REPRO_TORCH_TRACE_SHARDS", "").strip()
    if raw:
        try:
            n = int(raw)
        except ValueError as exc:
            raise ValueError(
                f"REPRO_TORCH_TRACE_SHARDS must be a positive integer, "
                f"got {raw!r}") from exc
        if n < 1:
            raise ValueError(
                f"REPRO_TORCH_TRACE_SHARDS must be a positive integer, "
                f"got {n}")
        return n
    return max(1, os.cpu_count() or 1)


def _peak_rss_kb() -> int:
    """Peak resident set size of this process in KiB (-1 if unavailable)."""
    try:
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:
        return -1


def _map_shards(fn, items: Sequence, n_workers: int) -> list:
    """Run ``fn`` over ``items`` on a thread pool (serial when 1 worker)."""
    if n_workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=min(n_workers, len(items))) as ex:
        return list(ex.map(fn, items))


# ---------------------------------------------------------------------------
# Stage 1+2a: per-shard generation and local sort
# ---------------------------------------------------------------------------

def _sorted_shard_keys(seed: int, n_nodes: int, n_edges: int, alpha: float,
                       shard: int, n_shards: int) -> np.ndarray:
    """Shard ``shard``'s edges as a sorted int64 composite-key array.

    Streams the shard's generation blocks, folds each chunk straight
    into ``sender * V + receiver`` keys (the snd/rcv chunk arrays are
    transient — peak memory is one key array plus one block), then
    sorts in place.
    """
    B = synthetic.POWER_LAW_STREAM_CHUNK
    n_blocks = synthetic.power_law_stream_blocks(n_edges)
    owned = sum(min(B, n_edges - b * B)
                for b in range(shard, n_blocks, n_shards))
    keys = np.empty(owned, dtype=np.int64)
    at = 0
    for snd, rcv in synthetic.power_law_edge_stream(
            seed, n_nodes=n_nodes, n_edges=n_edges, alpha=alpha,
            shard=shard, n_shards=n_shards):
        k = np.multiply(snd, n_nodes, dtype=np.int64)
        k += rcv
        keys[at:at + k.size] = k
        at += k.size
    keys.sort()
    return keys


# ---------------------------------------------------------------------------
# Stage 2b: splitters, exchange, per-bucket factorization
# ---------------------------------------------------------------------------

def _sample_splitters(sorted_shards: Sequence[np.ndarray],
                      n_buckets: int) -> np.ndarray:
    """Deterministic bucket boundaries from regular per-shard samples.

    Returns ``<= n_buckets - 1`` strictly increasing keys; bucket ``b``
    owns the half-open key range ``[split[b-1], split[b])`` (with
    ``-inf`` / ``+inf`` at the ends).  Boundaries are a pure function of
    the shard contents, so every shard computes the same split without
    communication beyond the (tiny) sample exchange.
    """
    samples = []
    for ks in sorted_shards:
        if not ks.size:
            continue
        take = min(ks.size, n_buckets * _SPLITTER_OVERSAMPLE)
        idx = (np.arange(take, dtype=np.int64) * ks.size) // take
        samples.append(ks[idx])
    if not samples or n_buckets <= 1:
        return np.empty(0, dtype=np.int64)
    s = np.sort(np.concatenate(samples))
    cut = (np.arange(1, n_buckets, dtype=np.int64) * s.size) // n_buckets
    # Duplicate sample values would only create empty buckets; unique
    # keeps the boundary list strictly increasing.
    return np.unique(s[cut])


def _bucket_pieces(keys: np.ndarray, split: np.ndarray) -> list[np.ndarray]:
    """Split one shard's sorted keys into per-bucket contiguous views.

    ``side="left"`` sends keys equal to a boundary to the bucket on its
    right — the half-open ``[split[b-1], split[b])`` convention every
    shard shares, which is what guarantees all copies of a key meet in
    one bucket.
    """
    cuts = np.searchsorted(keys, split, side="left")
    bounds = np.concatenate(
        [np.zeros(1, np.int64), cuts, np.full(1, keys.size, np.int64)])
    return [keys[bounds[i]:bounds[i + 1]] for i in range(bounds.size - 1)]


def _factorize_bucket(pieces: Sequence[np.ndarray]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Merge one bucket's per-shard pieces into (unique keys, counts)."""
    pieces = [p for p in pieces if p.size]
    if not pieces:
        z = np.empty(0, dtype=np.int64)
        return z, z
    if len(pieces) == 1:
        merged = pieces[0]  # a sorted view: read-only here, no copy needed
    else:
        merged = np.concatenate(pieces)
        merged.sort()  # fresh array: in-place is safe
    change = np.empty(merged.size, dtype=bool)
    change[0] = True
    np.not_equal(merged[1:], merged[:-1], out=change[1:])
    idx = np.flatnonzero(change)
    u_key = merged[idx]
    counts = np.empty(idx.size, dtype=np.int64)
    counts[:-1] = np.diff(idx)
    counts[-1] = merged.size - idx[-1]
    return u_key, counts


def sharded_power_law_factorization(*, n_nodes: int, n_edges: int,
                                    seed: int = 0, alpha: float = 1.6,
                                    n_shards: Optional[int] = None,
                                    stats: Optional[dict] = None,
                                    ) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Sharded build of the sender-major unique-pair factorization.

    Returns ``(u_snd, u_rcv, mult_prefix)`` — bit-identical (values,
    order, dtypes) to what :meth:`GraphTrace._pair_factorization`
    derives from the materialized ``power_law_stream`` edge list with
    the same parameters, for **every** shard count (the drift-gate
    contract).  ``stats``, when a dict, receives per-stage wall times,
    per-shard edge counts, and peak-RSS snapshots.
    """
    n_nodes = int(n_nodes)
    n_edges = int(n_edges)
    if n_nodes > MAX_KEY_NODES:
        raise NotImplementedError(
            f"sharded factorization needs composite int64 keys "
            f"(n_nodes <= {MAX_KEY_NODES}); got n_nodes={n_nodes}. "
            f"Use the single-host lexsort path.")
    if n_shards is None:
        n_shards = default_shard_count()
    n_shards = max(1, int(n_shards))
    # Generation shards own whole blocks, so more shards than blocks
    # would just idle — but the exchange still buckets into ``n_shards``
    # key ranges (one per device), so small graphs exercise the full
    # all-to-all of an 8-device mesh too.
    n_gen = max(1, min(n_shards, synthetic.power_law_stream_blocks(n_edges)))
    n_workers = min(n_shards, os.cpu_count() or 1)

    t0 = time.perf_counter()
    sorted_shards = _map_shards(
        lambda s: _sorted_shard_keys(seed, n_nodes, n_edges, alpha,
                                     s, n_gen),
        range(n_gen), n_workers)
    t1 = time.perf_counter()
    rss_gen = _peak_rss_kb()

    split = _sample_splitters(sorted_shards, n_shards)
    # The "all-to-all": shard s splits its run against the shared
    # boundaries; bucket b then owns piece b of every shard.
    pieces = _map_shards(lambda ks: _bucket_pieces(ks, split),
                         sorted_shards, n_workers)
    buckets = _map_shards(_factorize_bucket,
                          [[p[b] for p in pieces]
                           for b in range(split.size + 1)], n_workers)
    u_key = np.concatenate([b[0] for b in buckets])
    counts = np.concatenate([b[1] for b in buckets])
    dt = np.int32 if n_nodes <= np.iinfo(np.int32).max else np.int64
    u_snd = (u_key // n_nodes).astype(dt, copy=False)
    u_rcv = (u_key % n_nodes).astype(dt, copy=False)
    mult_prefix = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=mult_prefix[1:])
    t2 = time.perf_counter()

    if stats is not None:
        stats.update({
            "n_shards": int(n_shards),
            "n_generation_shards": int(n_gen),
            "shard_edges": [int(ks.size) for ks in sorted_shards],
            "bucket_unique": [int(b[0].size) for b in buckets],
            "n_unique_pairs": int(counts.size),
            "t_generate_sort_s": t1 - t0,
            "t_exchange_factorize_s": t2 - t1,
            "rss_generate_sort_kb": rss_gen,
            "rss_exchange_factorize_kb": _peak_rss_kb(),
        })
    return u_snd, u_rcv, mult_prefix


def build_power_law_trace(*, n_nodes: int, n_edges: int, seed: int = 0,
                          alpha: float = 1.6,
                          n_shards: Optional[int] = None,
                          stats: Optional[dict] = None):
    """Sharded end-to-end build: factorization → edge-list-free trace.

    The returned :class:`~repro_torch.core.trace.GraphTrace` carries the
    unique-pair factorization and an O(U)-recovered CSR row pointer but
    no materialized edge list — peak memory is the factorization plus
    one shard's keys, which is what lets ``power_law_sharded`` datasets
    reach 10⁸–10⁹ edges on one host.
    """
    from ..core.trace import GraphTrace

    u_snd, u_rcv, mult_prefix = sharded_power_law_factorization(
        n_nodes=n_nodes, n_edges=n_edges, seed=seed, alpha=alpha,
        n_shards=n_shards, stats=stats)
    t0 = time.perf_counter()
    trace = GraphTrace.from_factorization(
        int(n_nodes), u_snd, u_rcv, mult_prefix)
    if stats is not None:
        stats["t_csr_s"] = time.perf_counter() - t0
        stats["rss_csr_kb"] = _peak_rss_kb()
    return trace


# ---------------------------------------------------------------------------
# Stage 3: sharded per-capacity schedule counts (engine="sharded")
# ---------------------------------------------------------------------------

def _segment_chunk_bounds(u_new_src: np.ndarray, n_parts: int) -> np.ndarray:
    """Chunk boundaries over the factorization, aligned to new-sender
    boundaries so no deduplicated ``(dst_tile, source)`` run crosses a
    chunk edge (runs end where the sender changes)."""
    U = int(u_new_src.size)
    if n_parts <= 1 or U == 0:
        return np.array([0, U], dtype=np.int64)
    targets = (np.arange(1, n_parts, dtype=np.int64) * U) // n_parts
    ns_idx = np.flatnonzero(u_new_src)
    pos = np.minimum(np.searchsorted(ns_idx, targets, side="left"),
                     ns_idx.size - 1)
    return np.unique(np.concatenate(
        [np.zeros(1, np.int64), ns_idx[pos], np.full(1, U, np.int64)]))


def sharded_schedule_counts(fact: tuple, K: int, n_tiles: int,
                            n_shards: Optional[int] = None,
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (halo, remote-edge) counts via sharded boundary-flag passes.

    ``fact`` is ``(u_snd, u_rcv, u_new_src, mult_prefix)`` from
    :meth:`GraphTrace._pair_factorization`.  The factorization is split
    at new-sender boundaries (:func:`_segment_chunk_bounds`), each chunk
    runs the same O(U) pass as the single-host engine — every chunk
    start is a pair start in the global pass, so per-chunk
    ``boundary[0] = True`` is exact, not an approximation — and the
    partial per-tile bincounts are summed.  Integer counts throughout:
    the result is bit-identical to the single-host engine for any shard
    count.
    """
    u_snd, u_rcv, u_new_src, mp = fact
    U = int(u_snd.size)
    halo = np.zeros(n_tiles, dtype=np.int64)
    remote_edges = np.zeros(n_tiles, dtype=np.int64)
    if U == 0:
        return halo, remote_edges
    if n_shards is None:
        n_shards = default_shard_count()
    bounds = _segment_chunk_bounds(u_new_src, int(n_shards))
    Kd = u_rcv.dtype.type(K)

    def one_chunk(se: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
        s, e = se
        tile_u = u_rcv[s:e] // Kd
        n = e - s
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        np.logical_or(u_new_src[s + 1:e], tile_u[1:] != tile_u[:-1],
                      out=boundary[1:])
        pidx = np.flatnonzero(boundary)
        nxt = np.empty(pidx.size, dtype=np.int64)
        nxt[:-1] = pidx[1:]
        nxt[-1] = n
        pair_tile = tile_u[pidx].astype(np.int64, copy=False)
        pair_count = np.asarray(mp)[s + nxt] - np.asarray(mp)[s + pidx]
        remote = (u_snd[s + pidx] // Kd) != tile_u[pidx]
        h = np.bincount(pair_tile[remote], minlength=n_tiles)
        # weighted bincount returns float64; multiplicities are ints
        # < 2^53, so the partial (and its sum below) is exact
        r = np.bincount(pair_tile[remote], weights=pair_count[remote],
                        minlength=n_tiles)
        return h.astype(np.int64, copy=False), r.astype(np.int64)

    chunks = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
    n_workers = min(len(chunks), os.cpu_count() or 1)
    for h, r in _map_shards(one_chunk, chunks, n_workers):
        halo += h
        remote_edges += r
    return halo, remote_edges


def typed_sharded_schedule_counts(typed_trace, K: int, n_tiles: int,
                                  n_shards: Optional[int] = None,
                                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-relation per-tile (halo, remote-edge) counts, sharded.

    The typed factorization (DESIGN.md §17) keeps every relation's
    unique-pair factorization as a contiguous slice of one shared sort,
    so the sharded boundary-flag pass applies per relation unchanged:
    relation ``r``'s slice is itself a sender-major factorization, and
    :func:`sharded_schedule_counts` runs on it exactly as on a
    homogeneous trace.  Returns ``(halo, remote_edges)`` as
    ``(n_relations, n_tiles)`` int64 arrays — row ``r`` bit-identical to
    the single-host counts of ``typed_trace.relation(r)`` for any shard
    count (the typed extension of the drift-gate contract).
    """
    R = int(typed_trace.n_relations)
    halo = np.zeros((R, n_tiles), dtype=np.int64)
    remote = np.zeros((R, n_tiles), dtype=np.int64)
    for r in range(R):
        fact = typed_trace.relation(r)._pair_factorization()
        halo[r], remote[r] = sharded_schedule_counts(
            fact, K, n_tiles, n_shards=n_shards)
    return halo, remote


# ---------------------------------------------------------------------------
# Drift gate helper
# ---------------------------------------------------------------------------

def factorization_drift(fact_a: Sequence, fact_b: Sequence,
                        names: Sequence[str] = ("u_snd", "u_rcv",
                                                "mult_prefix")) -> list[str]:
    """Bit-exact comparison of two factorizations; [] means zero drift.

    Checks values, order, *and* dtypes — the sharded path must be a
    drop-in for the single-host factorization, so a silent int64
    widening counts as drift too.
    """
    errs = []
    for name, a, b in zip(names, fact_a, fact_b):
        a = np.asarray(a)
        b = np.asarray(b)
        if a.dtype != b.dtype:
            errs.append(f"{name}: dtype {a.dtype} != {b.dtype}")
        if a.shape != b.shape:
            errs.append(f"{name}: shape {a.shape} != {b.shape}")
            continue
        if not np.array_equal(a, b):
            i = int(np.flatnonzero(a != b)[0])
            errs.append(f"{name}: first mismatch at index {i}: "
                        f"{a[i]} != {b[i]}")
    return errs
