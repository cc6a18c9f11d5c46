"""Exact tile schedules from real edge lists (a copy of the reference's
``repro/core/trace.py``: homogeneous and typed traces), with the segment
reduce on the card.

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
has three engines:

* ``"torch"`` (the default): kernel K4 (:func:`repro_torch.kernels.ops.
  schedule_counts`) on ``device``, which is CUDA unless the caller passes
  ``device="cpu"`` (then the plain PyTorch version runs).  The
  factorization goes to the device once per trace and device;
* ``"numpy"``: the reference's host pass, kept verbatim;
* ``"sharded"``: the same host pass split at new-sender boundaries over a
  thread pool (:func:`repro_torch.distributed.trace_shard.
  sharded_schedule_counts`).

All three give bit-identical integers, and
:meth:`GraphTrace.schedule_reference` keeps the per-capacity ``np.unique``
algorithm as the oracle.  Datasets registered with a ``cache_token`` also
persist their factorization and every schedule in the content-addressed
disk cache
(:mod:`repro_torch.core.schedule_cache`): a warm process skips the
generator, the sort and K4.

A :class:`TypedGraphTrace` (an edge list whose edges carry a relation id)
shares one sort across its relations; each relation's trace is a slice of
it, scheduled by the same two engines.
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
from . import schedule_cache

__all__ = [
    "GraphTrace",
    "TypedGraphTrace",
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

_ENGINES = ("torch", "numpy", "sharded")

#: Process-wide work counters (observability, not behaviour): edge-list
#: sorts, schedule computations, schedule-LRU hits and dataset builds.
_TRACE_STATS = {
    "factorizations": 0,     # actual sorts (not disk-cache loads)
    "schedule_computes": 0,  # per-capacity O(U) boundary-flag passes
    "schedule_cache_hits": 0,  # per-trace LRU hits
    "schedule_disk_hits": 0,   # on-disk schedule_cache hits
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
            order = np.lexsort((-pair_count, pair_tile))  # lint: allow-trace-lexsort
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
        # (u_snd, u_rcv, mult_prefix) of a disk-cached graph, finished into
        # ``_fact`` on the first schedule query.
        self._fact_source: Optional[tuple] = None
        # (dataset, canonical params, cache token) of a tokened dataset:
        # the disk-cache identity of its schedules.
        self._disk_identity: Optional[tuple[str, str, str]] = None
        self._csr_senders: Optional[np.ndarray] = None
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

    @classmethod
    def _from_cached(cls, d: Mapping[str, Any]) -> "GraphTrace":
        """Rebuild from a :mod:`repro_torch.core.schedule_cache` graph
        payload.  Trusted: no validation and no sort.  The arrays may be
        memory-mapped and nothing here reads them, so a warm resolve costs
        directory stats and header reads; the factorization is finished on
        the first schedule query."""
        has_fact = all(k in d for k in ("fact_u_snd", "fact_u_rcv",
                                        "fact_mult_prefix"))
        has_edges = "senders" in d and "receivers" in d
        if "row_ptr" not in d or not (has_fact or has_edges):
            return cls(d["senders"], d["receivers"], d["n_nodes"])
        obj = cls.__new__(cls)
        obj.n_nodes = int(d["n_nodes"])
        if has_edges:
            obj.senders = d["senders"]
            obj.receivers = d["receivers"]
            obj._n_edges = int(obj.senders.shape[0])
        else:
            obj.senders = np.empty(0, dtype=np.int64)
            obj.receivers = np.empty(0, dtype=np.int64)
            obj._n_edges = int(d["n_edges"])
        obj.row_ptr = d["row_ptr"]
        obj._init_state(None)
        obj._csr_senders = d.get("csr_senders")
        if has_fact:
            obj._fact_source = (d["fact_u_snd"], d["fact_u_rcv"],
                                d["fact_mult_prefix"])
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
    def csr_senders(self) -> np.ndarray:
        """CSR column array: source vertices in destination-major order
        (senders ascend within each destination row), built lazily on
        first access (schedule queries never need it).  Edge-list traces
        sort a receiver-major composite key; factorization-only traces
        expand the unique pairs re-sorted receiver-major (the same result:
        within a (receiver, sender) run the expansion is order-free)."""
        with self._lock:
            if self._csr_senders is None:
                self._csr_senders = self._build_csr_senders()
            return self._csr_senders

    def _build_csr_senders(self) -> np.ndarray:
        V = self.n_nodes
        if self._n_edges == 0:
            return np.empty(0, dtype=np.int64)
        if self.has_edge_list:
            if V <= int((2**63 - 1) ** 0.5):
                key = np.multiply(self.receivers, V, dtype=np.int64)
                key += self.senders
                key.sort()
                key %= V  # in place: the sorted keys become the columns
                return key
            # V^2 would overflow the int64 composite key.
            order = np.lexsort((self.senders, self.receivers))  # lint: allow-trace-lexsort
            return np.asarray(self.senders, dtype=np.int64)[order]
        u_snd, u_rcv, _, mp = self._pair_factorization()
        # U-sized (unique pairs), not E-sized.
        order = np.lexsort((u_snd, u_rcv))  # lint: allow-trace-lexsort
        return np.repeat(np.asarray(u_snd, dtype=np.int64)[order],
                         np.diff(mp)[order])

    @property
    def nbytes(self) -> int:
        """Host footprint estimate (edge arrays, factorization, cached
        schedules): the quantity the trace-cache budget bounds."""
        n = (self.senders.nbytes + self.receivers.nbytes
             + self.row_ptr.nbytes)
        if self._csr_senders is not None:
            n += self._csr_senders.nbytes
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
            if self._fact_source is not None:
                # Disk-cached (maybe memory-mapped): only the new-sender
                # mask is left to build, O(U), no sort.
                u_snd, u_rcv, mp = self._fact_source
                mp = np.asarray(mp, dtype=np.int64)
                self._fact = self._finish_factorization(
                    u_snd, u_rcv, mp[:-1], int(mp[-1]))
                self._fact_source = None
            elif E == 0:
                z = np.zeros(0, dtype=np.int64)
                self._fact = (z, z, np.zeros(0, dtype=bool),
                              np.zeros(1, dtype=np.int64))
            elif not self.has_edge_list:
                raise RuntimeError(
                    "factorization-only trace lost its factorization")
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
                order = np.lexsort((self.receivers, self.senders))  # lint: allow-trace-lexsort
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
                # Disk-cached pairs are read-only maps: torch takes a
                # writable copy of those.
                tensors = tuple(
                    torch.from_numpy(np.require(a, requirements="CW")).to(dev)
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

    def _compute_schedules_sharded(self, caps: Sequence[int]
                                   ) -> list[TraceSchedule]:
        """The ``"sharded"`` engine: the O(U) host pass split at new-sender
        boundaries and run per shard; the integer partial counts are summed
        (:mod:`repro_torch.distributed.trace_shard`)."""
        from ..distributed import trace_shard

        out = []
        for cap in caps:
            _bump_stat("schedule_computes")
            n_tiles, K = self._geometry(cap)
            halo, remote = trace_shard.sharded_schedule_counts(
                self._pair_factorization(), K, n_tiles)
            out.append(self._schedule_from_counts(
                cap, n_tiles, K, halo.astype(np.float64),
                remote.astype(np.float64)))
        return out

    def _compute(self, caps: Sequence[int], engine: str,
                 device) -> list[TraceSchedule]:
        if engine == "torch":
            return self._compute_schedules_torch(caps, device)
        if engine == "sharded":
            return self._compute_schedules_sharded(caps)
        return [self._compute_schedule(c) for c in caps]

    # -- schedule cache plumbing ------------------------------------------
    def _cached_schedule(self, cap: int) -> Optional[TraceSchedule]:
        """The LRU's schedule, else the disk cache's, else None."""
        sched = self._schedules.get(cap)
        if sched is not None:
            self._schedules.move_to_end(cap)
            _bump_stat("schedule_cache_hits")
            return sched
        return self._schedule_from_disk(cap)

    def _remember_schedule(self, cap: int, sched: TraceSchedule, *,
                           to_disk: bool = True) -> None:
        self._schedules[cap] = sched
        self._schedules.move_to_end(cap)
        limit = max(1, int(self.schedule_cache_entries))
        while len(self._schedules) > limit:
            self._schedules.popitem(last=False)
        if to_disk:
            self._schedule_to_disk(cap, sched)

    def _disk_key(self, cap: int) -> Optional[str]:
        """The schedule's disk-cache key, or None when it takes no part."""
        if self._disk_identity is None:
            return None
        if self.n_edges < schedule_cache.min_cached_edges():
            return None
        return schedule_cache.schedule_cache_key(*self._disk_identity, cap)

    def _schedule_from_disk(self, cap: int) -> Optional[TraceSchedule]:
        key = self._disk_key(cap)
        d = None if key is None else schedule_cache.load_schedule(key)
        if d is None:
            return None
        _bump_stat("schedule_disk_hits")
        sched = TraceSchedule(
            n_tiles=d["n_tiles"], capacity=d["capacity"], K=d["K"],
            vertex_counts=d["vertex_counts"], edge_counts=d["edge_counts"],
            halo_counts=d["halo_counts"],
            remote_edge_counts=d["remote_edge_counts"],
            _pair_source=functools.partial(self._pairs_for, d["K"]))
        self._remember_schedule(cap, sched, to_disk=False)
        return sched

    def _schedule_to_disk(self, cap: int, sched: TraceSchedule) -> None:
        key = self._disk_key(cap)
        if key is not None:
            schedule_cache.store_schedule(key, **sched.counts_dict())

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
        ``engine="numpy"``, that pass split over shards for
        ``engine="sharded"``; bit-identical integers.
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
        order = np.lexsort((-pair_count, pair_tile))  # lint: allow-trace-lexsort
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


class TypedGraphTrace:
    """A heterogeneous (typed) edge list: ``senders[i] -> receivers[i]``
    carries relation ``rels[i]`` (an RGCN-style edge type).

    Folding ``rel`` into the composite sort key, ``(rel * V + sender) * V
    + receiver``, makes one in-place ``np.sort`` produce the unique ``(rel,
    sender, receiver)`` triples in relation-major, sender-major order, so
    every relation's unique-pair factorization is a contiguous **slice** of
    one shared sort.  :meth:`relation` hands each slice to
    :meth:`GraphTrace.from_factorization` (edge-list-free, no further
    sort), after which a relation's schedules are the homogeneous engine's:
    kernel K4 on ``device`` for ``engine="torch"``, the host pass for
    ``engine="numpy"``.  They are bit-identical to R independently built
    single-relation traces.
    """

    def __init__(self, senders, receivers, rels, n_nodes: int,
                 n_relations: int) -> None:
        snd = np.asarray(senders)
        rcv = np.asarray(receivers)
        rel = np.asarray(rels)
        if not (snd.ndim == rcv.ndim == rel.ndim == 1
                and snd.shape == rcv.shape == rel.shape):
            raise ValueError(
                f"senders/receivers/rels must be 1-D arrays of equal "
                f"length, got shapes {snd.shape}, {rcv.shape}, {rel.shape}")
        if not all(np.issubdtype(a.dtype, np.integer)
                   for a in (snd, rcv, rel)):
            raise ValueError("senders/receivers/rels must be integer arrays")
        n_nodes = int(n_nodes)
        n_relations = int(n_relations)
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if n_relations < 1:
            raise ValueError(f"n_relations must be >= 1, got {n_relations}")
        if snd.size and (snd.min() < 0 or snd.max() >= n_nodes
                         or rcv.min() < 0 or rcv.max() >= n_nodes):
            raise ValueError(
                f"edge endpoints must lie in [0, {n_nodes})")
        if rel.size and (rel.min() < 0 or rel.max() >= n_relations):
            raise ValueError(
                f"relation ids must lie in [0, {n_relations}); got range "
                f"[{rel.min()}, {rel.max()}]")
        self.n_nodes = n_nodes
        self.n_relations = n_relations
        self.senders = snd
        self.receivers = rcv
        self.rels = rel
        self._n_edges = int(snd.size)
        self._fact: Optional[tuple] = None
        self._relation_traces: dict[int, GraphTrace] = {}
        # Reentrant: relation() holds it across _typed_factorization().
        self._lock = threading.RLock()

    # -- basic measures ----------------------------------------------------
    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def nbytes(self) -> int:
        """Host footprint (edge arrays, shared factorization, and the
        per-relation traces carved out of it): the trace-cache unit."""
        n = self.senders.nbytes + self.receivers.nbytes + self.rels.nbytes
        fact = self._fact
        if fact is not None:
            n += sum(a.nbytes for a in fact)
        for t in list(self._relation_traces.values()):
            n += t.nbytes
        return int(n)

    def clear_schedules(self) -> None:
        """Drop every per-relation schedule LRU (memory reclaim, or between
        engines: the LRU is keyed on capacity alone)."""
        for t in list(self._relation_traces.values()):
            t.clear_schedules()

    def relation_edge_counts(self) -> np.ndarray:
        """``(n_relations,)`` int64 edges per relation (exact)."""
        _, _, _, mp, rel_ptr = self._typed_factorization()
        return np.diff(mp[rel_ptr])

    # -- the shared typed factorization ------------------------------------
    def _typed_factorization(self) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray,
                                            np.ndarray]:
        """One sort shared by every (relation, capacity) query.

        Returns ``(u_rel, u_snd, u_rcv, mult_prefix, rel_ptr)``: unique
        ``(rel, sender, receiver)`` triples in relation-major sender-major
        order, the int64 edge-multiplicity prefix over the triples
        (length ``U+1``), and ``rel_ptr`` (length ``R+1``) delimiting
        each relation's contiguous triple range.
        """
        with self._lock:
            return self._typed_factorization_locked()

    def _typed_factorization_locked(self):
        if self._fact is None:
            V = self.n_nodes
            R = self.n_relations
            E = self._n_edges
            if E == 0:
                z = np.zeros(0, dtype=np.int64)
                self._fact = (z, z, z, np.zeros(1, dtype=np.int64),
                              np.zeros(R + 1, dtype=np.int64))
                return self._fact
            if R * V <= (2**63 - 1) // V:
                _bump_stat("factorizations")
                # rel folded into the composite key: one in-place sort
                # covers every relation (range R*V^2, checked).
                key = np.multiply(self.rels, V, dtype=np.int64)
                key += self.senders
                key *= V
                key += self.receivers
                key.sort()
                change = np.empty(E, dtype=bool)
                change[0] = True
                np.not_equal(key[1:], key[:-1], out=change[1:])
                idx = np.flatnonzero(change)
                u_key = key[idx]
                dt = (np.int32 if V <= np.iinfo(np.int32).max else np.int64)
                u_rcv = (u_key % V).astype(dt, copy=False)
                u_key //= V
                u_snd = (u_key % V).astype(dt, copy=False)
                u_rel = (u_key // V).astype(np.int64, copy=False)
            else:
                # R*V^2 would overflow the int64 composite key.
                _bump_stat("factorizations")
                order = np.lexsort((self.receivers, self.senders, self.rels))  # lint: allow-trace-lexsort
                rel_s = self.rels[order]
                snd_s = self.senders[order]
                rcv_s = self.receivers[order]
                change = np.empty(E, dtype=bool)
                change[0] = True
                np.logical_or.reduce([rel_s[1:] != rel_s[:-1],
                                      snd_s[1:] != snd_s[:-1],
                                      rcv_s[1:] != rcv_s[:-1]],
                                     out=change[1:])
                idx = np.flatnonzero(change)
                u_rel = rel_s[idx].astype(np.int64, copy=False)
                u_snd = snd_s[idx]
                u_rcv = rcv_s[idx]
            mult_prefix = np.empty(idx.size + 1, dtype=np.int64)
            mult_prefix[:-1] = idx
            mult_prefix[-1] = E
            rel_ptr = np.searchsorted(u_rel, np.arange(R + 1)).astype(np.int64)
            self._fact = (u_rel, u_snd, u_rcv, mult_prefix, rel_ptr)
        return self._fact

    # -- per-relation traces -----------------------------------------------
    def relation(self, r: int) -> GraphTrace:
        """The single-relation :class:`GraphTrace` of relation ``r``.

        Carved from the shared typed factorization: the slice
        ``rel_ptr[r]:rel_ptr[r+1]`` is already a sender-major unique-pair
        factorization of relation r's edge multiset, so the trace is
        built edge-list-free through :meth:`GraphTrace.from_factorization`
        with its multiplicity prefix rebased: no per-relation sort, no
        edge list.  Traces (and their per-capacity schedule LRUs) are
        cached per relation.
        """
        r = int(r)
        if not 0 <= r < self.n_relations:
            raise ValueError(f"relation must lie in [0, {self.n_relations}), "
                             f"got {r}")
        with self._lock:
            trace = self._relation_traces.get(r)
            if trace is None:
                _, u_snd, u_rcv, mp, rel_ptr = self._typed_factorization()
                lo, hi = int(rel_ptr[r]), int(rel_ptr[r + 1])
                local_prefix = mp[lo:hi + 1] - mp[lo]
                trace = GraphTrace.from_factorization(
                    self.n_nodes, u_snd[lo:hi], u_rcv[lo:hi], local_prefix)
                self._relation_traces[r] = trace
            return trace

    def relation_traces(self) -> tuple[GraphTrace, ...]:
        """All per-relation traces, in relation order (one shared sort)."""
        return tuple(self.relation(r) for r in range(self.n_relations))

    def relation_schedules(self, tile_vertices, *, engine: str = "torch",
                           device=None) -> tuple[TraceSchedule, ...]:
        """One capacity across every relation: ``(R,)`` schedules, each
        relation's halo and cut counts from K4 on ``device`` for
        ``engine="torch"`` (CUDA unless ``device="cpu"``).

        All relations share the trace's vertex set, so the partition
        geometry (``n_tiles``, ``K``, per-tile vertex counts) is common;
        only the edge/halo/cut counts differ per relation.
        """
        return tuple(self.relation(r).schedule(tile_vertices, engine=engine,
                                               device=device)
                     for r in range(self.n_relations))


# ---------------------------------------------------------------------------
# Dataset registry: names a scenario file can reference, resolving to the
# deterministic generators in repro_torch.data.synthetic.
# ---------------------------------------------------------------------------
#: name -> (builder, cache token or None).
_TRACE_DATASETS: dict[str, tuple[Callable[..., Any], Optional[str]]] = {}
_TRACE_CACHE: "OrderedDict[tuple, GraphTrace]" = OrderedDict()
#: In-process resolved-trace budget; oldest entries evict beyond it (the
#: most recent trace always stays, even when alone it exceeds the budget).
_TRACE_CACHE_BUDGET_BYTES = 1 << 30


def register_trace_dataset(name: str, builder: Callable[..., GraphTrace], *,
                           overwrite: bool = False,
                           cache_token: Optional[str] = None) -> None:
    """Register a named trace dataset builder (kwargs -> GraphTrace).

    Builders must be deterministic in their parameters so a serialized
    trace scenario replays bit-identically; anything random is keyed by an
    explicit ``seed`` parameter.  ``cache_token`` opts the dataset into the
    on-disk graph and schedule cache (:mod:`repro_torch.core.
    schedule_cache`): it is the builder's version stamp, to be bumped
    whenever its output changes for identical parameters.  Datasets without
    one never touch the disk.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"dataset name must be a non-empty string, got {name!r}")
    with _CACHE_LOCK:
        if name in _TRACE_DATASETS and not overwrite:
            raise ValueError(f"trace dataset {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _TRACE_DATASETS[name] = (builder, cache_token)
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
                          ) -> "GraphTrace | TypedGraphTrace":
    """Build a dataset, or fetch it from the in-process LRU or the disk.

    Thread-safe: the whole resolve (LRU probe, disk load, builder call,
    disk store, insert) holds the process-wide cache lock, so concurrent
    resolutions of one key cost exactly one build.
    """
    params = dict(params or {})
    with _CACHE_LOCK:
        if name not in _TRACE_DATASETS:
            raise KeyError(f"unknown trace dataset {name!r}; "
                           f"registered: {list(trace_dataset_names())}")
        builder, token = _TRACE_DATASETS[name]
        key = _cache_key(name, params)
        cached = _TRACE_CACHE.get(key)
        if cached is not None:
            _TRACE_CACHE.move_to_end(key)
            return cached
        identity = (name, key[1], token)
        trace = None
        if token is not None:
            payload = schedule_cache.load_graph(
                schedule_cache.graph_cache_key(*identity))
            if payload is not None:
                trace = GraphTrace._from_cached(payload)
        if trace is None:
            _bump_stat("trace_builds")
            try:
                trace = builder(**params)
            except TypeError as exc:
                raise ValueError(
                    f"bad parameters {sorted(params)} for trace dataset "
                    f"{name!r}: {exc}") from exc
            if token is not None:
                _store_graph(trace, identity)
        if token is not None:
            trace._disk_identity = identity
        _TRACE_CACHE[key] = trace
        _TRACE_CACHE.move_to_end(key)
        _evict_to_budget()
        return trace


def _store_graph(trace: GraphTrace, identity: tuple[str, str, str]) -> None:
    """Persist a freshly built tokened trace: its factorization (sorted here
    once), row pointer and edge list, so a warm process skips the generator
    and every sort.  ``csr_senders`` goes along only if already built.  With
    the cache off nothing happens: the sort stays lazy."""
    if (schedule_cache.cache_root() is None
            or trace.n_edges < schedule_cache.min_cached_edges()):
        return
    u_snd, u_rcv, _, mp = trace._pair_factorization()
    kw = {}
    if trace.has_edge_list and trace.n_edges:
        kw["senders"] = trace.senders
        kw["receivers"] = trace.receivers
    if trace._csr_senders is not None:
        kw["csr_senders"] = trace._csr_senders
    schedule_cache.store_graph(
        schedule_cache.graph_cache_key(*identity), n_nodes=trace.n_nodes,
        n_edges=trace.n_edges, row_ptr=trace.row_ptr, fact_u_snd=u_snd,
        fact_u_rcv=u_rcv, fact_mult_prefix=mp, **kw)


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


def _power_law_sharded_trace(*, n_nodes, n_edges, seed=0,
                             alpha=1.6) -> GraphTrace:
    """The ``power_law_stream`` graph built by the sharded pipeline
    (:mod:`repro_torch.distributed.trace_shard`): the same edge multiset and
    a bit-identical factorization, but edge-list-free, so it reaches 10^8
    edges and more.  The shard count comes from ``REPRO_TORCH_TRACE_SHARDS``
    (else the CPU count) and never enters the cache key."""
    from ..distributed import trace_shard

    return trace_shard.build_power_law_trace(
        n_nodes=int(n_nodes), n_edges=int(n_edges), seed=int(seed),
        alpha=float(alpha))


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


def _relation_assignment(seed, n_edges: int, n_relations: int) -> np.ndarray:
    """Deterministic per-edge relation ids (seed-keyed, like synthetic)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x9e37]))
    return rng.integers(0, int(n_relations), size=int(n_edges),
                        dtype=np.int64)


def _typed_power_law_trace(*, n_nodes, n_edges, n_relations, seed=0,
                           alpha=1.6) -> TypedGraphTrace:
    """The ``power_law`` edge list with seed-keyed random edge types: the
    same (sender, receiver) multiset as ``power_law`` for identical
    ``(n_nodes, n_edges, seed, alpha)``."""
    from ..data import synthetic

    ga = synthetic.power_law_graph(
        int(seed), n_nodes=int(n_nodes), n_edges=int(n_edges), d_feat=1,
        alpha=float(alpha), self_loops=False)
    rels = _relation_assignment(seed, int(n_edges), int(n_relations))
    return TypedGraphTrace(ga.senders, ga.receivers, rels, int(n_nodes),
                           int(n_relations))


def _typed_blocks_trace(*, n_relations, n_nodes, n_edges, seed=0,
                        alpha=1.6) -> TypedGraphTrace:
    """Block-diagonal typed fixture: relation r's edges live entirely in
    vertex block ``[r*n_nodes, (r+1)*n_nodes)`` (R disjoint power-law
    graphs under one vertex numbering)."""
    from ..data import synthetic

    R = int(n_relations)
    nn = int(n_nodes)
    snd_parts, rcv_parts, rel_parts = [], [], []
    for r in range(R):
        ga = synthetic.power_law_graph(
            int(seed) * 7919 + r, n_nodes=nn, n_edges=int(n_edges),
            d_feat=1, alpha=float(alpha), self_loops=False)
        snd_parts.append(ga.senders.astype(np.int64) + r * nn)
        rcv_parts.append(ga.receivers.astype(np.int64) + r * nn)
        rel_parts.append(np.full(int(n_edges), r, dtype=np.int64))
    return TypedGraphTrace(np.concatenate(snd_parts),
                           np.concatenate(rcv_parts),
                           np.concatenate(rel_parts), R * nn, R)


def _typed_cora_trace(*, n_relations=3, seed=0, alpha=1.6) -> TypedGraphTrace:
    """Cora-sized typed graph: Cora's V/E, R edge types assigned from the
    seed."""
    return _typed_power_law_trace(
        n_nodes=CORA_V, n_edges=CORA_E, n_relations=int(n_relations),
        seed=int(seed), alpha=float(alpha))


register_trace_dataset("power_law", _power_law_trace, cache_token="v1")
register_trace_dataset("power_law_stream", _power_law_stream_trace,
                       cache_token="v1")
register_trace_dataset("power_law_sharded", _power_law_sharded_trace,
                       cache_token="v1")
register_trace_dataset("cora", _cora_trace)
register_trace_dataset("molecule", _molecule_trace)
register_trace_dataset("ring_of_tiles", _ring_of_tiles_trace)
register_trace_dataset("typed_power_law", _typed_power_law_trace)
register_trace_dataset("typed_blocks", _typed_blocks_trace)
register_trace_dataset("typed_cora", _typed_cora_trace)
