"""Exact tile schedules from real edge lists (a copy of the reference's
``repro/core/trace.py``, homogeneous part), with the segment reduce on the
card.

The paper's composition covers a full graph with *uniform* tiles and charges
halo reloads at the random-partition expected cut ``E * (1 - 1/n_tiles)``.
A :class:`GraphTrace` wraps one concrete edge list and derives, for a
balanced contiguous vertex partition, the exact quantities that schedule
approximates: per-tile vertex and edge counts, per-tile **unique** remote
source counts (the true halo) and cut edges, and degree-aware cache hit
fractions.

Every tile is a contiguous receiver range, so ``dst_tile = receiver // K`` is
monotone in the receiver for every capacity.  One sender-major sort, done
once per trace on the host and collapsed to the unique ``(sender,
receiver)`` pairs with an edge-multiplicity prefix, makes the deduplicated
``(dst_tile, source)`` pairs of any capacity contiguous runs.  A capacity
then costs one O(U) boundary-flag pass over the U unique pairs.  That pass
has two engines:

* ``"torch"`` (the default): kernel K4 (:func:`repro_torch.kernels.ops.
  schedule_counts`) on ``device``, which is CUDA unless the caller passes
  ``device="cpu"`` (then the plain PyTorch version runs).  The
  factorization goes to the device once per trace and device;
* ``"numpy"``: the reference's host pass, kept verbatim.

Both give bit-identical integers, and :meth:`GraphTrace.schedule_reference`
keeps the per-capacity ``np.unique`` algorithm as the oracle.
"""

from __future__ import annotations

import functools
import json
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..backend import resolve_device

__all__ = [
    "GraphTrace",
    "TraceSchedule",
    "register_trace_dataset",
    "resolve_trace_dataset",
    "trace_dataset_names",
    "clear_trace_cache",
    "set_trace_cache_budget",
    "trace_cache_info",
    "reset_trace_stats",
    "CORA_V",
    "CORA_E",
]

#: Cora citation-graph size (the reference's two constants).
CORA_V = 2708
CORA_E = 10556

_ENGINES = ("torch", "numpy")

#: Process-wide work counters (observability, not behaviour): edge-list
#: sorts, schedule computations, schedule-LRU hits and dataset builds.
_TRACE_STATS = {
    "factorizations": 0,     # actual sorts
    "schedule_computes": 0,  # per-capacity O(U) boundary-flag passes
    "schedule_cache_hits": 0,  # per-trace LRU hits
    "trace_builds": 0,       # dataset builder invocations (cold resolves)
}

#: Guards ``_TRACE_STATS`` read-modify-write cycles.
_STATS_LOCK = threading.Lock()

#: Guards the resolved-trace LRU, its byte budget and the dataset registry.
#: Reentrant: a cold resolve holds it across the builder call.
_CACHE_LOCK = threading.RLock()


def _bump_stat(name: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _TRACE_STATS[name] += n


def reset_trace_stats() -> None:
    """Zero the process-wide trace work counters (see trace_cache_info)."""
    with _STATS_LOCK:
        for key in _TRACE_STATS:
            _TRACE_STATS[key] = 0


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


@dataclass(frozen=True)
class TraceSchedule:
    """Exact per-tile schedule of one (trace, tile capacity) pair.

    Tile ``t`` owns the contiguous vertex range ``[t*K, min((t+1)*K, V))``
    with ``n_tiles = ceil(V / capacity)`` and ``K = ceil(V / n_tiles)``, the
    same balanced split the uniform schedule assumes.

    Attributes:
      n_tiles: number of tiles.
      capacity: requested tile vertex capacity.
      K: owned-vertex stride (``ceil(V / n_tiles)``).
      vertex_counts: ``(n_tiles,)`` exact vertices per tile.
      edge_counts: ``(n_tiles,)`` exact edges per destination tile.
      halo_counts: ``(n_tiles,)`` exact **unique** remote sources per tile.
      remote_edge_counts: ``(n_tiles,)`` cut edges per destination tile
        (before dedup; ``halo_counts <= remote_edge_counts``).

    The ranked per-(tile, source) multiplicities behind
    :meth:`cache_hit_fraction` are derived lazily from ``_pair_source`` (a
    callable returning ``(pair_tile, pair_count)``) and memoized.
    """

    n_tiles: int
    capacity: int
    K: int
    vertex_counts: np.ndarray
    edge_counts: np.ndarray
    halo_counts: np.ndarray
    remote_edge_counts: np.ndarray
    _pair_source: Optional[Callable[[], tuple]] = field(
        default=None, repr=False, compare=False)
    _ranked_cache: Optional[tuple] = field(
        default=None, repr=False, compare=False)

    @property
    def n_edges(self) -> int:
        return int(self.edge_counts.sum())

    @property
    def cut_edges(self) -> int:
        """Total edges whose source tile differs from their destination tile."""
        return int(self.remote_edge_counts.sum())

    @property
    def halo_total(self) -> int:
        """Total unique-remote-source fetches across all tiles (exact halo)."""
        return int(self.halo_counts.sum())

    def uniform_halo_estimate(self) -> float:
        """The paper's random-partition expected cut, ``E * (1 - 1/n_tiles)``."""
        return float(self.n_edges) * (1.0 - 1.0 / self.n_tiles)

    def counts_dict(self) -> dict:
        """The integer count arrays (the parity payload)."""
        return {"n_tiles": self.n_tiles, "capacity": self.capacity,
                "K": self.K, "vertex_counts": self.vertex_counts,
                "edge_counts": self.edge_counts,
                "halo_counts": self.halo_counts,
                "remote_edge_counts": self.remote_edge_counts}

    def _ranked_pairs(self) -> tuple:
        """(seg_ptr, prefix): per-tile segments of count-descending pairs.

        Pairs are ranked by ``(tile asc, count desc, source asc)``, the
        order of the ``np.unique`` reference, and reduced to a segment
        pointer plus an inclusive int64 prefix sum, so the top-L cache hits
        of any L are two gather-subtractions.
        """
        cached = self._ranked_cache
        if cached is None:
            if self._pair_source is None:
                raise RuntimeError(
                    "this TraceSchedule carries no pair source; cache-hit "
                    "statistics need the (tile, source) multiplicities")
            pair_tile, pair_count = self._pair_source()
            # Stable sort: ties in (tile, -count) keep the provider's
            # source-ascending order, matching the np.unique reference.
            order = np.lexsort((-pair_count, pair_tile))
            pt = pair_tile[order]
            pc = pair_count[order]
            seg_ptr = np.searchsorted(pt, np.arange(self.n_tiles + 1))
            prefix = np.zeros(pc.size + 1, dtype=np.int64)
            np.cumsum(pc, out=prefix[1:])
            cached = (seg_ptr.astype(np.int64), prefix)
            object.__setattr__(self, "_ranked_cache", cached)
        return cached

    def cache_hit_fraction(self, high_degree_fraction=0.1) -> np.ndarray:
        """Exact per-tile degree-aware cache hit fractions.

        If tile ``t`` pins its ``L_t = floor(K_t * high_degree_fraction)``
        most-referenced source vertices in a dedicated cache (EnGN's L2*),
        this is the fraction of the tile's aggregation reads they serve.
        ``high_degree_fraction`` may be a scalar or an array; the result
        broadcasts to ``hdf.shape + (n_tiles,)``.
        """
        hdf = _f64(high_degree_fraction)
        if not np.all(np.isfinite(hdf)) or np.any(hdf < 0.0) or np.any(hdf > 1.0):
            raise ValueError(f"high_degree_fraction must be in [0, 1], "
                             f"got {high_degree_fraction!r}")
        seg_ptr, prefix = self._ranked_pairs()
        seg_start = seg_ptr[:-1]
        seg_len = np.diff(seg_ptr)
        L = np.floor(self.vertex_counts * hdf[..., None]).astype(np.int64)
        take = np.minimum(L, seg_len)
        hits = (prefix[seg_start + take] - prefix[seg_start]).astype(np.float64)
        return hits / np.maximum(self.edge_counts, 1.0)

    def stats(self, high_degree_fraction: float = 0.1) -> dict:
        """Summary record for benchmarks / result metadata (JSON-able)."""
        est = self.uniform_halo_estimate()
        exact = self.halo_total
        edge = _f64(self.edge_counts)
        hit = self.cache_hit_fraction(high_degree_fraction)
        return {
            "n_tiles": int(self.n_tiles),
            "capacity": int(self.capacity),
            "n_edges": int(self.n_edges),
            "cut_edges": int(self.cut_edges),
            "halo_exact": int(exact),
            "halo_uniform_estimate": est,
            "halo_estimate_over_exact": (est / exact) if exact else None,
            "edge_imbalance": float(edge.max() / max(edge.mean(), 1e-300)),
            "cache_hit_fraction_mean": float(hit.mean()),
            "cache_hit_fraction_min": float(hit.min()),
            "cache_hit_fraction_max": float(hit.max()),
        }


class GraphTrace:
    """One concrete directed edge list, CSR-ified by destination vertex.

    ``senders[i] -> receivers[i]`` is edge ``i``; aggregation reads source
    features into destination vertices.  Construction builds the CSR row
    pointer by destination (an O(E) bincount); the first schedule request
    builds the one sender-major unique-pair factorization every capacity
    shares, after which each capacity is one O(U) segmented pass.
    """

    #: Per-trace schedule LRU bound (distinct capacities kept in memory).
    schedule_cache_entries: int = 64

    def __init__(self, senders, receivers, n_nodes: int) -> None:
        snd = np.asarray(senders)
        rcv = np.asarray(receivers)
        if snd.ndim != 1 or rcv.ndim != 1 or snd.shape != rcv.shape:
            raise ValueError(
                f"senders/receivers must be 1-D arrays of equal length, got "
                f"shapes {snd.shape} and {rcv.shape}")
        if not (np.issubdtype(snd.dtype, np.integer)
                and np.issubdtype(rcv.dtype, np.integer)):
            raise ValueError("senders/receivers must be integer vertex ids")
        n_nodes = int(n_nodes)
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if snd.size and (snd.min() < 0 or snd.max() >= n_nodes
                         or rcv.min() < 0 or rcv.max() >= n_nodes):
            raise ValueError(
                f"edge endpoints must lie in [0, {n_nodes}); got sender "
                f"range [{snd.min()}, {snd.max()}] and receiver range "
                f"[{rcv.min()}, {rcv.max()}]")
        self.n_nodes = n_nodes
        # Edge arrays keep their (validated) integer dtype; downstream ops
        # promote explicitly where int64 range is needed.
        self.senders = snd
        self.receivers = rcv
        self._n_edges = int(snd.size)
        counts = np.bincount(rcv, minlength=n_nodes)
        self.row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self.row_ptr[1:])
        self._init_state(None)

    def _init_state(self, fact: Optional[tuple]) -> None:
        self._fact = fact
        self._device_fact: dict[str, tuple[torch.Tensor, ...]] = {}
        self._schedules: "OrderedDict[int, TraceSchedule]" = OrderedDict()
        # Reentrant: schedule() holds it across _pair_factorization().
        self._lock = threading.RLock()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_arrays(cls, graph) -> "GraphTrace":
        """From anything with ``senders`` / ``receivers`` / ``n_nodes``
        attributes (e.g. :class:`repro_torch.data.synthetic.GraphArrays`)."""
        return cls(graph.senders, graph.receivers, graph.n_nodes)

    @classmethod
    def from_factorization(cls, n_nodes: int, u_snd, u_rcv, mult_prefix, *,
                           row_ptr=None) -> "GraphTrace":
        """Build an edge-list-free trace from a unique-pair factorization.

        ``(u_snd, u_rcv)`` are the unique (sender, receiver) pairs in
        sender-major order and ``mult_prefix`` the int64 edge-multiplicity
        prefix (length ``U + 1``; ``mult_prefix[-1] == E``).  The CSR row
        pointer is recovered in O(U) unless ``row_ptr`` is given.  Every
        schedule quantity works; only :meth:`schedule_reference`, which
        re-derives everything from raw edges, raises.
        """
        n_nodes = int(n_nodes)
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        u_snd = np.asarray(u_snd)
        u_rcv = np.asarray(u_rcv)
        if not np.issubdtype(u_snd.dtype, np.integer):
            u_snd = u_snd.astype(np.int64)  # e.g. an empty Python list
        if not np.issubdtype(u_rcv.dtype, np.integer):
            u_rcv = u_rcv.astype(np.int64)
        mult_prefix = np.asarray(mult_prefix, dtype=np.int64)
        if not (u_snd.ndim == u_rcv.ndim == mult_prefix.ndim == 1
                and u_snd.size == u_rcv.size == mult_prefix.size - 1):
            raise ValueError(
                f"need 1-D u_snd/u_rcv of equal length U and a length-U+1 "
                f"mult_prefix; got {u_snd.shape}, {u_rcv.shape}, "
                f"{mult_prefix.shape}")
        obj = cls.__new__(cls)
        obj.n_nodes = n_nodes
        edge_dt = u_snd.dtype if u_snd.size else np.int64
        obj.senders = np.empty(0, dtype=edge_dt)
        obj.receivers = np.empty(0, dtype=edge_dt)
        obj._n_edges = int(mult_prefix[-1]) if mult_prefix.size else 0
        if row_ptr is not None:
            obj.row_ptr = np.asarray(row_ptr, dtype=np.int64)
            if obj.row_ptr.shape != (n_nodes + 1,):
                raise ValueError(f"row_ptr must have shape ({n_nodes + 1},), "
                                 f"got {obj.row_ptr.shape}")
        else:
            # Exact int64 accumulation: a weighted np.bincount would go
            # through float64 and round multiplicity sums past 2^53.
            counts = np.zeros(n_nodes, dtype=np.int64)
            np.add.at(counts, u_rcv, np.diff(mult_prefix))
            obj.row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
            np.cumsum(counts, out=obj.row_ptr[1:])
        obj._init_state(cls._finish_factorization(
            u_snd, u_rcv, mult_prefix[:-1], obj._n_edges))
        return obj

    # -- basic measures ----------------------------------------------------
    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def has_edge_list(self) -> bool:
        """False for factorization-only traces."""
        return self.senders.shape[0] == self._n_edges

    @property
    def nbytes(self) -> int:
        """Host footprint estimate (edge arrays, factorization, cached
        schedules): the quantity the trace-cache budget bounds."""
        n = (self.senders.nbytes + self.receivers.nbytes
             + self.row_ptr.nbytes)
        fact = self._fact
        if fact is not None:
            n += sum(a.nbytes for a in fact)
        # Snapshot: the budget evictor reads concurrently with inserts.
        for s in list(self._schedules.values()):
            n += (s.vertex_counts.nbytes + s.edge_counts.nbytes
                  + s.halo_counts.nbytes + s.remote_edge_counts.nbytes)
            if s._ranked_cache is not None:
                n += sum(a.nbytes for a in s._ranked_cache)
        return int(n)

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def out_degrees(self) -> np.ndarray:
        if not self.has_edge_list:
            u_snd, _, _, mp = self._pair_factorization()
            # int64-exact (a weighted bincount would round past 2^53)
            deg = np.zeros(self.n_nodes, dtype=np.int64)
            np.add.at(deg, u_snd, np.diff(mp))
            return deg
        return np.bincount(self.senders, minlength=self.n_nodes)

    # -- the shared factorization ------------------------------------------
    def _pair_factorization(self) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        """The one sorted-edge factorization every capacity shares.

        Returns ``(u_snd, u_rcv, u_new_src, mult_prefix)``: the unique
        ``(sender, receiver)`` pairs in sender-major order (compact dtype),
        the new-sender mask, and the int64 edge-multiplicity prefix
        (length ``U+1``).  The sort is one in-place ``np.sort`` over
        composite ``sender * V + receiver`` keys, done once on the host.
        """
        with self._lock:
            return self._pair_factorization_locked()

    def _pair_factorization_locked(self) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
        if self._fact is None:
            V = self.n_nodes
            E = self.n_edges
            if E == 0:
                z = np.zeros(0, dtype=np.int64)
                self._fact = (z, z, np.zeros(0, dtype=bool),
                              np.zeros(1, dtype=np.int64))
            elif V <= int((2**63 - 1) ** 0.5):
                _bump_stat("factorizations")
                # dtype pinned: int32 edge arrays must not decide the key
                # width (the composite range is V^2, not V)
                key = np.multiply(self.senders, V, dtype=np.int64)
                key += self.receivers  # in place: one less E-sized pass
                key.sort()  # fresh array: safe to sort in place
                change = np.empty(E, dtype=bool)
                change[0] = True
                np.not_equal(key[1:], key[:-1], out=change[1:])
                idx = np.flatnonzero(change)
                u_key = key[idx]
                dt = (np.int32 if V <= np.iinfo(np.int32).max else np.int64)
                u_snd = (u_key // V).astype(dt, copy=False)
                u_rcv = (u_key % V).astype(dt, copy=False)
                self._fact = self._finish_factorization(u_snd, u_rcv, idx, E)
            else:
                # Composite keys would overflow int64: stable lexsort path.
                _bump_stat("factorizations")
                order = np.lexsort((self.receivers, self.senders))
                snd_s = self.senders[order]
                rcv_s = self.receivers[order]
                change = np.empty(E, dtype=bool)
                change[0] = True
                np.logical_or(snd_s[1:] != snd_s[:-1],
                              rcv_s[1:] != rcv_s[:-1], out=change[1:])
                idx = np.flatnonzero(change)
                self._fact = self._finish_factorization(
                    snd_s[idx], rcv_s[idx], idx, E)
        return self._fact

    @staticmethod
    def _finish_factorization(u_snd, u_rcv, idx, E):
        u_new_src = np.empty(u_snd.size, dtype=bool)
        if u_snd.size:
            u_new_src[0] = True
            np.not_equal(u_snd[1:], u_snd[:-1], out=u_new_src[1:])
        # idx[j] is the edge offset of pair j's first edge, so idx itself
        # IS the multiplicity prefix (append E to close the last run).
        mult_prefix = np.empty(idx.size + 1, dtype=np.int64)
        mult_prefix[:-1] = idx
        mult_prefix[-1] = E
        return (u_snd, u_rcv, u_new_src, mult_prefix)

    def _device_factorization(self, dev: torch.device
                              ) -> tuple[torch.Tensor, ...]:
        """``(u_snd, u_rcv, u_new_src, mult)`` on ``dev``, moved there once
        per trace and device and shared by every capacity."""
        with self._lock:
            key = str(dev)
            tensors = self._device_fact.get(key)
            if tensors is None:
                u_snd, u_rcv, u_new_src, mp = self._pair_factorization()
                tensors = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (u_snd, u_rcv, u_new_src, np.diff(mp)))
                self._device_fact[key] = tensors
            return tensors

    def _geometry(self, cap: int) -> tuple[int, int]:
        n_tiles = -(-self.n_nodes // cap)
        K = -(-self.n_nodes // n_tiles)
        return n_tiles, K

    def _tile_boundaries(self, n_tiles: int, K: int) -> np.ndarray:
        return np.minimum(np.arange(n_tiles + 1, dtype=np.int64) * K,
                          self.n_nodes)

    def _pair_runs(self, K: int) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """(pair_tile, pair_count, remote, src_at_run) for stride K.

        One O(U) host pass over the shared factorization: a ``(dst_tile,
        source)`` pair starts wherever the sender changes or the tile of
        the (per-sender ascending) receiver does; its edge multiplicity is
        a difference of the multiplicity prefix.
        """
        u_snd, u_rcv, u_new_src, mp = self._pair_factorization()
        U = u_snd.size
        if not U:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=bool), z
        Kd = u_rcv.dtype.type(K)
        tile_u = u_rcv // Kd
        boundary = np.empty(U, dtype=bool)
        boundary[0] = True
        np.logical_or(u_new_src[1:], tile_u[1:] != tile_u[:-1],
                      out=boundary[1:])
        pidx = np.flatnonzero(boundary)
        nxt = np.empty(pidx.size, dtype=np.int64)
        nxt[:-1] = pidx[1:]
        nxt[-1] = U
        pair_tile = tile_u[pidx].astype(np.int64, copy=False)
        pair_count = mp[nxt] - mp[pidx]
        src = u_snd[pidx]
        remote = (src // Kd) != tile_u[pidx]
        return pair_tile, pair_count, remote, src

    def _pairs_for(self, K: int) -> tuple[np.ndarray, np.ndarray]:
        """Deduplicated ``(dst_tile, source)`` pairs for stride K, in
        source-major order (tile ascending within each source)."""
        pair_tile, pair_count, _, _ = self._pair_runs(K)
        return pair_tile, pair_count

    @staticmethod
    def _validate_cap(tile_vertices) -> int:
        cap = int(tile_vertices)
        if cap != float(tile_vertices) or cap < 1:
            raise ValueError(f"tile_vertices must be a whole number >= 1 "
                             f"for a trace schedule, got {tile_vertices!r}")
        return cap

    def _schedule_from_counts(self, cap: int, n_tiles: int, K: int,
                              halo_counts: np.ndarray,
                              remote_edge_counts: np.ndarray
                              ) -> TraceSchedule:
        boundaries = self._tile_boundaries(n_tiles, K)
        return TraceSchedule(
            n_tiles=int(n_tiles), capacity=int(cap), K=int(K),
            vertex_counts=np.diff(boundaries).astype(np.float64),
            edge_counts=np.diff(self.row_ptr[boundaries]).astype(np.float64),
            halo_counts=halo_counts, remote_edge_counts=remote_edge_counts,
            _pair_source=functools.partial(self._pairs_for, K))

    def _compute_schedule(self, cap: int) -> TraceSchedule:
        """One capacity on the host (the ``"numpy"`` engine): O(U)."""
        _bump_stat("schedule_computes")
        n_tiles, K = self._geometry(cap)
        pair_tile, pair_count, remote, _ = self._pair_runs(K)
        if pair_tile.size:
            # A pair is remote when its source lives outside the
            # destination tile; summing the run multiplicities recovers
            # the (pre-dedup) cut edges.
            halo_counts = np.bincount(
                pair_tile[remote], minlength=n_tiles).astype(np.float64)
            # int64 accumulation, float64 only at the boundary.
            rec = np.zeros(n_tiles, dtype=np.int64)
            np.add.at(rec, pair_tile[remote],
                      np.asarray(pair_count[remote], dtype=np.int64))
            remote_edge_counts = rec.astype(np.float64)
        else:
            halo_counts = np.zeros(n_tiles, dtype=np.float64)
            remote_edge_counts = np.zeros(n_tiles, dtype=np.float64)
        return self._schedule_from_counts(cap, n_tiles, K, halo_counts,
                                          remote_edge_counts)

    def _compute_schedules_torch(self, caps: Sequence[int],
                                 device) -> list[TraceSchedule]:
        """The ``"torch"`` engine: kernel K4 per capacity on ``device``.

        Every capacity launches on the shared device factorization; the
        counts of the whole sweep come back to the host in one copy.
        """
        from ..kernels import ops

        tensors = self._device_factorization(resolve_device(device))
        geos = [(cap, *self._geometry(cap)) for cap in caps]
        parts = []
        for _, n_tiles, K in geos:
            _bump_stat("schedule_computes")
            parts.extend(ops.schedule_counts(*tensors, K, n_tiles,
                                             total=self.n_edges))
        flat = torch.cat(parts).cpu().numpy()
        out, at = [], 0
        for cap, n_tiles, K in geos:
            halo = flat[at:at + n_tiles].astype(np.float64)
            cut = flat[at + n_tiles:at + 2 * n_tiles].astype(np.float64)
            at += 2 * n_tiles
            out.append(self._schedule_from_counts(cap, n_tiles, K, halo, cut))
        return out

    def _compute(self, caps: Sequence[int], engine: str,
                 device) -> list[TraceSchedule]:
        if engine == "torch":
            return self._compute_schedules_torch(caps, device)
        return [self._compute_schedule(c) for c in caps]

    # -- schedule cache plumbing ------------------------------------------
    def _cached_schedule(self, cap: int) -> Optional[TraceSchedule]:
        sched = self._schedules.get(cap)
        if sched is not None:
            self._schedules.move_to_end(cap)
            _bump_stat("schedule_cache_hits")
        return sched

    def _remember_schedule(self, cap: int, sched: TraceSchedule) -> None:
        self._schedules[cap] = sched
        self._schedules.move_to_end(cap)
        limit = max(1, int(self.schedule_cache_entries))
        while len(self._schedules) > limit:
            self._schedules.popitem(last=False)

    def clear_schedules(self) -> None:
        """Drop the per-trace schedule LRU (memory reclaim).

        The LRU is keyed on capacity alone, not on the engine: a caller
        comparing engines on one trace clears it in between.
        """
        with self._lock:
            self._schedules.clear()

    # -- the partitioner ---------------------------------------------------
    @staticmethod
    def _check_engine(engine: str) -> None:
        if engine not in _ENGINES:
            raise ValueError(f"unknown trace engine {engine!r}; "
                             f"expected one of {_ENGINES}")

    def schedule(self, tile_vertices, *, engine: str = "torch",
                 device=None) -> TraceSchedule:
        """Exact balanced-partition schedule for one tile capacity (cached).

        Tile membership is integer division by the stride, per-tile edge
        counts are CSR row-pointer differences at the tile boundaries, and
        halo / cut counts are one boundary-flag pass over the shared
        unique-pair factorization: kernel K4 on ``device`` (CUDA unless
        ``device="cpu"``) for ``engine="torch"``, the host pass for
        ``engine="numpy"``; bit-identical integers.
        """
        return self.schedules([tile_vertices], engine=engine,
                              device=device)[0]

    def schedules(self, tile_vertices: Sequence, *, engine: str = "torch",
                  device=None) -> tuple[TraceSchedule, ...]:
        """Batched multi-capacity schedules sharing one factorization.

        The sweep costs one shared (cached) factorization plus a linear
        segmented pass per *distinct* capacity; results come back in input
        order (duplicates allowed) and land in the per-trace LRU.
        """
        caps = [self._validate_cap(c) for c in tile_vertices]
        self._check_engine(engine)
        # Results are held locally so a sweep wider than the schedule LRU
        # still returns every schedule.  The lock is held across the
        # compute so concurrent callers of one capacity compute it once.
        found: dict[int, TraceSchedule] = {}
        missing = []
        with self._lock:
            for cap in dict.fromkeys(caps):
                sched = self._cached_schedule(cap)
                if sched is None:
                    missing.append(cap)
                else:
                    found[cap] = sched
            if missing:
                for cap, sched in zip(missing, self._compute(
                        missing, engine, device)):
                    self._remember_schedule(cap, sched)
                    found[cap] = sched
        return tuple(found[c] for c in caps)

    def schedule_reference(self, tile_vertices) -> TraceSchedule:
        """The per-capacity ``np.unique`` algorithm, kept as the oracle.

        One ``np.unique`` over composite ``(tile, source)`` keys plus an
        eager ranking lexsort per call, O(E log E) per capacity, on the
        host.  Results are not cached.
        """
        cap = self._validate_cap(tile_vertices)
        if not self.has_edge_list:
            raise RuntimeError(
                "schedule_reference needs the materialized edge list; this "
                "trace is factorization-only.  Rebuild it from raw "
                "senders/receivers to run the oracle.")
        V = self.n_nodes
        n_tiles, K = self._geometry(cap)
        boundaries = self._tile_boundaries(n_tiles, K)
        vertex_counts = np.diff(boundaries).astype(np.float64)
        edge_counts = np.diff(self.row_ptr[boundaries]).astype(np.float64)
        dst_tile = self.receivers // K
        src_tile = self.senders // K
        remote = src_tile != dst_tile
        remote_edge_counts = np.bincount(
            dst_tile[remote], minlength=n_tiles).astype(np.float64)
        keys = dst_tile * np.int64(V) + self.senders
        pairs, pair_count = np.unique(keys, return_counts=True)
        pair_tile = (pairs // V).astype(np.int64)
        remote_pair = (pairs % V) // K != pair_tile
        halo_counts = np.bincount(
            pair_tile[remote_pair], minlength=n_tiles).astype(np.float64)
        order = np.lexsort((-pair_count, pair_tile))
        ranked_tile = pair_tile[order]
        ranked_count = pair_count[order]
        seg_ptr = np.searchsorted(ranked_tile, np.arange(n_tiles + 1))
        prefix = np.zeros(ranked_count.size + 1, dtype=np.int64)
        np.cumsum(ranked_count, out=prefix[1:])
        return TraceSchedule(
            n_tiles=int(n_tiles), capacity=cap, K=int(K),
            vertex_counts=vertex_counts, edge_counts=edge_counts,
            halo_counts=halo_counts, remote_edge_counts=remote_edge_counts,
            _pair_source=lambda: (pair_tile, pair_count),
            _ranked_cache=(seg_ptr.astype(np.int64), prefix))


# ---------------------------------------------------------------------------
# Dataset registry: names a scenario file can reference, resolving to the
# deterministic generators in repro_torch.data.synthetic.
# ---------------------------------------------------------------------------
_TRACE_DATASETS: dict[str, Callable[..., GraphTrace]] = {}
_TRACE_CACHE: "OrderedDict[tuple, GraphTrace]" = OrderedDict()
#: In-process resolved-trace budget; oldest entries evict beyond it (the
#: most recent trace always stays, even when alone it exceeds the budget).
_TRACE_CACHE_BUDGET_BYTES = 1 << 30


def register_trace_dataset(name: str, builder: Callable[..., GraphTrace], *,
                           overwrite: bool = False) -> None:
    """Register a named trace dataset builder (kwargs -> GraphTrace).

    Builders must be deterministic in their parameters so a serialized
    trace scenario replays bit-identically; anything random is keyed by an
    explicit ``seed`` parameter.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"dataset name must be a non-empty string, got {name!r}")
    with _CACHE_LOCK:
        if name in _TRACE_DATASETS and not overwrite:
            raise ValueError(f"trace dataset {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _TRACE_DATASETS[name] = builder
        # Replacing a builder invalidates traces resolved under the old one.
        for key in [k for k in _TRACE_CACHE if k[0] == name]:
            del _TRACE_CACHE[key]


def trace_dataset_names() -> tuple[str, ...]:
    with _CACHE_LOCK:
        return tuple(sorted(_TRACE_DATASETS))


def _canonical_params(params: Mapping[str, Any]) -> str:
    """Sorted-JSON canonical form of a params mapping.

    Nested dicts/lists and numpy scalars serialize deterministically, and
    integer-valued floats canonicalize to their integer (``1000000.0`` ==
    ``1000000``), so the scenario front door (which normalizes params to
    floats) and int-passing callers share one cache entry.
    """
    def canon(o):
        if isinstance(o, np.ndarray):
            o = o.tolist()
        if isinstance(o, np.generic):
            o = o.item()
        if isinstance(o, Mapping):
            return {str(k): canon(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [canon(v) for v in o]
        if isinstance(o, float) and not isinstance(o, bool) and o.is_integer():
            return int(o)
        return o

    def default(o):
        return repr(o)

    return json.dumps(canon(dict(params)), sort_keys=True,
                      separators=(",", ":"), default=default)


def _cache_key(name: str, params: Mapping[str, Any]) -> tuple:
    return (name, _canonical_params(params))


def _evict_to_budget() -> None:
    """Evict oldest traces until the byte budget holds (the most recent
    entry always survives).  Sizes are snapshotted once per call."""
    sizes = {k: t.nbytes for k, t in _TRACE_CACHE.items()}
    total = sum(sizes.values())
    while len(_TRACE_CACHE) > 1 and total > _TRACE_CACHE_BUDGET_BYTES:
        key, _ = _TRACE_CACHE.popitem(last=False)
        total -= sizes[key]


def set_trace_cache_budget(n_bytes: int) -> None:
    """Set the in-process resolved-trace LRU budget (bytes) and evict."""
    global _TRACE_CACHE_BUDGET_BYTES
    n_bytes = int(n_bytes)
    if n_bytes < 0:
        raise ValueError(f"trace cache budget must be >= 0 bytes, "
                         f"got {n_bytes!r}")
    with _CACHE_LOCK:
        _TRACE_CACHE_BUDGET_BYTES = n_bytes
        _evict_to_budget()


def trace_cache_info() -> dict:
    """Entries / bytes / budget of the in-process resolved-trace LRU, plus
    the process-wide work counters (``stats``)."""
    with _CACHE_LOCK:
        entries = len(_TRACE_CACHE)
        nbytes = int(sum(t.nbytes for t in _TRACE_CACHE.values()))
        budget = int(_TRACE_CACHE_BUDGET_BYTES)
    with _STATS_LOCK:
        stats = dict(_TRACE_STATS)
    return {"entries": entries, "bytes": nbytes,
            "budget_bytes": budget, "stats": stats}


def resolve_trace_dataset(name: str,
                          params: Optional[Mapping[str, Any]] = None,
                          ) -> GraphTrace:
    """Build a dataset, or fetch it from the in-process LRU.

    Thread-safe: the whole resolve holds the process-wide cache lock, so
    concurrent resolutions of one key cost exactly one build.
    """
    params = dict(params or {})
    with _CACHE_LOCK:
        if name not in _TRACE_DATASETS:
            raise KeyError(f"unknown trace dataset {name!r}; "
                           f"registered: {list(trace_dataset_names())}")
        key = _cache_key(name, params)
        cached = _TRACE_CACHE.get(key)
        if cached is not None:
            _TRACE_CACHE.move_to_end(key)
            return cached
        _bump_stat("trace_builds")
        try:
            trace = _TRACE_DATASETS[name](**params)
        except TypeError as exc:
            raise ValueError(
                f"bad parameters {sorted(params)} for trace dataset "
                f"{name!r}: {exc}") from exc
        _TRACE_CACHE[key] = trace
        _TRACE_CACHE.move_to_end(key)
        _evict_to_budget()
        return trace


def clear_trace_cache() -> None:
    """Drop resolved traces, and each one's per-capacity schedule LRU."""
    with _CACHE_LOCK:
        for trace in list(_TRACE_CACHE.values()):
            trace.clear_schedules()
        _TRACE_CACHE.clear()


def _power_law_trace(*, n_nodes, n_edges, seed=0, alpha=1.6) -> GraphTrace:
    from ..data import synthetic

    ga = synthetic.power_law_graph(
        int(seed), n_nodes=int(n_nodes), n_edges=int(n_edges), d_feat=1,
        alpha=float(alpha), self_loops=False)
    return GraphTrace.from_arrays(ga)


def _power_law_stream_trace(*, n_nodes, n_edges, seed=0,
                            alpha=1.6) -> GraphTrace:
    """Chunk-streamed power-law graph, the >= 10^6-edge scaling dataset:
    the ``power_law`` contract through
    :func:`repro_torch.data.synthetic.power_law_edges`, whose peak memory
    is bounded by the fixed chunk size."""
    from ..data import synthetic

    snd, rcv = synthetic.power_law_edges(
        int(seed), n_nodes=int(n_nodes), n_edges=int(n_edges),
        alpha=float(alpha))
    return GraphTrace(snd, rcv, int(n_nodes))


def _cora_trace(*, seed=0, alpha=1.6) -> GraphTrace:
    """Cora-sized deterministic power-law graph (V/E of Cora)."""
    return _power_law_trace(n_nodes=CORA_V, n_edges=CORA_E,
                            seed=int(seed), alpha=float(alpha))


def _molecule_trace(*, batch=128, n_nodes=30, n_edges=64, seed=0,
                    step=0) -> GraphTrace:
    """A molecule batch as one block-diagonal disjoint-union graph."""
    from ..data import synthetic

    b = synthetic.molecule_batch(int(seed), int(step), batch=int(batch),
                                 n_nodes=int(n_nodes), n_edges=int(n_edges),
                                 d_feat=1)
    offsets = (np.arange(int(batch), dtype=np.int64) * int(n_nodes))[:, None]
    snd = (b["senders"].astype(np.int64) + offsets).ravel()
    rcv = (b["receivers"].astype(np.int64) + offsets).ravel()
    return GraphTrace(snd, rcv, int(batch) * int(n_nodes))


def _ring_of_tiles_trace(*, n_nodes, n_tiles) -> GraphTrace:
    from ..data import synthetic

    ga = synthetic.ring_of_tiles_graph(n_nodes=int(n_nodes),
                                       n_tiles=int(n_tiles))
    return GraphTrace.from_arrays(ga)


register_trace_dataset("power_law", _power_law_trace)
register_trace_dataset("power_law_stream", _power_law_stream_trace)
register_trace_dataset("cora", _cora_trace)
register_trace_dataset("molecule", _molecule_trace)
register_trace_dataset("ring_of_tiles", _ring_of_tiles_trace)
