"""Content-addressed on-disk cache for trace graphs and tile schedules (a
copy of the reference's ``repro/core/schedule_cache.py`` with the port's own
root and variables).

A 10^7-edge trace costs seconds of generation and a host sort per process,
and every capacity a K4 launch.  This module gives
:mod:`repro_torch.core.trace` a small content-addressed store:

* **Graphs**: the unique-pair factorization plus the CSR row pointer of a
  :class:`~repro_torch.core.trace.GraphTrace` (and the raw edge list / CSR
  columns when the builder made them), keyed by ``sha256({dataset,
  canonical params, cache token, format version})``.  Each array is its
  own ``.npy`` file inside an atomically renamed ``<key>.graph/``
  directory, so a warm resolve memory-maps every array and reads nothing
  but headers until a schedule touches it.
* **Schedules**: the per-tile count arrays of one
  :class:`~repro_torch.core.trace.TraceSchedule`, keyed by the graph
  identity plus the tile capacity, one ``.npz``.  A disk hit skips K4.

The key derivation and the ``.npz`` field names are the reference's, so a
key of one package equals the other's for the same dataset, parameters and
token; the two never read each other's entries, because each reads its own
variable and defaults to its own root.  Only datasets registered with an
explicit ``cache_token`` take part.  Entries are written to a temp name and
``os.replace``-renamed; a torn or foreign entry is a miss that gets
dropped, never an error.

Configuration (read per call, so tests can monkeypatch):

* ``REPRO_TORCH_TRACE_CACHE``: the cache directory; ``0`` / ``off`` /
  empty disables it; unset means ``~/.cache/repro-torch-trace``.
* ``REPRO_TORCH_TRACE_CACHE_MIN_EDGES``: the smallest edge count worth a
  disk round trip (default 200000; small graphs rebuild faster than they
  load).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np

__all__ = [
    "cache_root",
    "min_cached_edges",
    "graph_cache_key",
    "schedule_cache_key",
    "load_graph",
    "store_graph",
    "load_schedule",
    "store_schedule",
    "cache_stats",
    "reset_cache_stats",
]

#: Bump when the on-disk layout of either artifact kind changes.  v2:
#: graphs became per-array ``.npy`` directories (mmap-lazy warm
#: resolves) with an optional edge list and a required factorization.
FORMAT_VERSION = 2

_DEFAULT_ROOT = "~/.cache/repro-torch-trace"
_DEFAULT_MIN_EDGES = 200_000
_DISABLED = {"", "0", "off", "none", "disabled"}

#: Graph payload arrays that may appear as ``<name>.npy`` parts.
_GRAPH_ARRAYS = ("senders", "receivers", "csr_senders", "row_ptr",
                 "fact_u_snd", "fact_u_rcv", "fact_mult_prefix")

#: Process-wide hit/miss/store counters for the disk cache, bumped only
#: when caching is enabled (a disabled cache is not a miss).  The serve
#: engine reads deltas of these per micro-batch window; the lock makes the
#: read-modify-write cycles exact under concurrency.
_CACHE_COUNTERS = {
    "graph_hits": 0,
    "graph_misses": 0,
    "graph_stores": 0,
    "schedule_hits": 0,
    "schedule_misses": 0,
    "schedule_stores": 0,
    "store_races": 0,   # benign lost store_graph renames (see store_graph)
}
_COUNTER_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNTER_LOCK:
        _CACHE_COUNTERS[name] += 1


def reset_cache_stats() -> None:
    """Zero the process-wide disk-cache counters (see :func:`cache_stats`)."""
    with _COUNTER_LOCK:
        for key in _CACHE_COUNTERS:
            _CACHE_COUNTERS[key] = 0


def cache_stats() -> dict:
    """Disk-cache observability: process counters plus an on-disk census.

    Returns ``{"enabled", "root", "counters", "entries", "bytes"}`` where
    ``entries`` counts ``*.graph`` directories and schedule ``*.npz``
    files currently under :func:`cache_root` and ``bytes`` sums their
    sizes.  The walk is **eviction-safe**: entries deleted concurrently
    (another process pruning the cache, a racing ``_drop_graph_dir``)
    are simply skipped, never an error — the census is a snapshot, not
    an invariant.
    """
    with _COUNTER_LOCK:
        counters = dict(_CACHE_COUNTERS)
    root = cache_root()
    out = {"enabled": root is not None,
           "root": str(root) if root is not None else None,
           "counters": counters,
           "entries": {"graphs": 0, "schedules": 0},
           "bytes": 0}
    if root is None or not root.is_dir():
        return out
    graphs = schedules = total = 0
    try:
        shards = list(root.iterdir())
    except OSError:
        return out
    for shard in shards:
        try:
            children = list(shard.iterdir()) if shard.is_dir() else []
        except OSError:
            continue  # shard pruned mid-walk
        for entry in children:
            try:
                if entry.name.endswith(".graph") and entry.is_dir():
                    graphs += 1
                    for part in entry.iterdir():
                        total += part.stat().st_size
                elif entry.suffix == ".npz" and entry.is_file():
                    schedules += 1
                    total += entry.stat().st_size
            except OSError:
                continue  # entry evicted mid-walk
    out["entries"] = {"graphs": graphs, "schedules": schedules}
    out["bytes"] = int(total)
    return out


def cache_root() -> Optional[Path]:
    """The cache directory, or None when disk caching is disabled."""
    raw = os.environ.get("REPRO_TORCH_TRACE_CACHE")
    if raw is None:
        raw = _DEFAULT_ROOT
    if raw.strip().lower() in _DISABLED:
        return None
    return Path(raw).expanduser()


def min_cached_edges() -> int:
    raw = os.environ.get("REPRO_TORCH_TRACE_CACHE_MIN_EDGES")
    if raw is None:
        return _DEFAULT_MIN_EDGES
    try:
        return max(0, int(raw))
    except ValueError:
        return _DEFAULT_MIN_EDGES


def _digest(payload: Mapping[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def graph_cache_key(dataset: str, canonical_params: str, token: str) -> str:
    return _digest({"kind": "graph", "dataset": dataset,
                    "params": canonical_params, "token": token,
                    "format": FORMAT_VERSION})


def schedule_cache_key(dataset: str, canonical_params: str, token: str,
                       capacity: int) -> str:
    return _digest({"kind": "schedule", "dataset": dataset,
                    "params": canonical_params, "token": token,
                    "capacity": int(capacity), "format": FORMAT_VERSION})


def _graph_dir(key: str) -> Optional[Path]:
    root = cache_root()
    if root is None:
        return None
    return root / key[:2] / f"{key}.graph"


def _schedule_path(key: str) -> Optional[Path]:
    root = cache_root()
    if root is None:
        return None
    return root / key[:2] / f"{key}.npz"


def _atomic_savez(path: Path, **arrays) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_npz(path: Optional[Path]) -> Optional[dict]:
    if path is None or not path.is_file():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {name: z[name] for name in z.files}
    except (OSError, ValueError, KeyError):
        # A torn or foreign file is a miss, never an error; drop it so the
        # next store rewrites a clean entry.
        try:
            path.unlink()
        except OSError:
            pass
        return None


def _compact_int(a: np.ndarray) -> np.ndarray:
    """int64 -> int32 when the values fit (halves cache size and load time)."""
    a = np.asarray(a)
    if a.dtype == np.int64 and (a.size == 0
                                or (a.min() >= np.iinfo(np.int32).min
                                    and a.max() <= np.iinfo(np.int32).max)):
        return a.astype(np.int32)
    return a


def _drop_graph_dir(path: Path) -> None:
    try:
        shutil.rmtree(path)
    except OSError:
        pass


# -- graphs -----------------------------------------------------------------
def load_graph(key: str) -> Optional[dict]:
    """Stored graph payload with **memory-mapped** arrays, or None on miss.

    Returns ``n_nodes`` / ``n_edges`` ints plus ``row_ptr`` (always) and
    whichever of the edge list, CSR columns, and unique-pair
    factorization were stored — every array an ``mmap_mode="r"`` view,
    so nothing is read beyond npy headers until a consumer indexes it.
    Compact on-disk dtypes are kept (:class:`~repro_torch.core.trace.
    GraphTrace` promotes explicitly where int64 range is needed; the
    multiplicity prefix is re-widened by its consumer).
    """
    path = _graph_dir(key)
    if path is None:
        return None
    if not path.is_dir():
        _count("graph_misses")
        return None
    try:
        meta = json.loads((path / "meta.json").read_text())
        out = {"n_nodes": int(meta["n_nodes"]),
               "n_edges": int(meta["n_edges"])}
        for name in _GRAPH_ARRAYS:
            part = path / f"{name}.npy"
            if part.is_file():
                out[name] = np.load(part, mmap_mode="r",
                                    allow_pickle=False)
        complete = "row_ptr" in out and (
            all(f"fact_{n}" in out
                for n in ("u_snd", "u_rcv", "mult_prefix"))
            or ("senders" in out and "receivers" in out))
        if not complete:
            raise ValueError(f"incomplete graph entry: {sorted(out)}")
        _count("graph_hits")
        return out
    except (OSError, ValueError, KeyError):
        # Torn writes can't happen (the rename is atomic), so anything
        # unreadable here is foreign or damaged: drop it -> miss.
        _drop_graph_dir(path)
        _count("graph_misses")
        return None


def store_graph(key: str, *, n_nodes: int, n_edges: int, row_ptr,
                senders=None, receivers=None, csr_senders=None,
                fact_u_snd=None, fact_u_rcv=None,
                fact_mult_prefix=None) -> bool:
    """Persist a graph payload as an atomically renamed part directory.

    ``row_ptr`` plus either the factorization trio or the raw edge list
    is required (the invariant :func:`load_graph` enforces); everything
    else is optional.  ``row_ptr`` stays int64 on disk — it is the one
    array :class:`~repro_torch.core.trace.GraphTrace` consumes at its contract
    dtype, and keeping it verbatim lets the mmap view stand in directly.
    """
    path = _graph_dir(key)
    if path is None:
        return False
    arrays = {"row_ptr": np.asarray(row_ptr, dtype=np.int64)}
    for name, a in (("senders", senders), ("receivers", receivers),
                    ("csr_senders", csr_senders),
                    ("fact_u_snd", fact_u_snd), ("fact_u_rcv", fact_u_rcv)):
        if a is not None:
            arrays[name] = _compact_int(a)
    if fact_mult_prefix is not None:
        arrays["fact_mult_prefix"] = _compact_int(fact_mult_prefix)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=path.parent, suffix=".tmp"))
        try:
            for name, a in arrays.items():
                np.save(tmp / f"{name}.npy", a, allow_pickle=False)
            (tmp / "meta.json").write_text(json.dumps(
                {"n_nodes": int(n_nodes), "n_edges": int(n_edges),
                 "format": FORMAT_VERSION}))
            if path.exists():
                # Concurrent writer won the rename race; its bytes are
                # identical (content-addressed), keep them.
                _drop_graph_dir(tmp)
                _count("store_races")
            else:
                try:
                    os.replace(tmp, path)
                except OSError:
                    # exists() -> replace() is a TOCTOU window: a racing
                    # writer can land the entry between the check and the
                    # rename, and os.replace onto a non-empty directory
                    # raises ENOTEMPTY.  Content-addressing makes the
                    # loser's bytes identical, so losing the race is a
                    # benign no-op — but only when the winner's entry is
                    # actually there; anything else is a real failure.
                    _drop_graph_dir(tmp)
                    if not path.exists():
                        raise
                    _count("store_races")
        except BaseException:
            _drop_graph_dir(tmp)
            raise
    except OSError:
        return False
    _count("graph_stores")
    return True


# -- schedules --------------------------------------------------------------
_SCHEDULE_FIELDS = ("vertex_counts", "edge_counts", "halo_counts",
                    "remote_edge_counts")


def load_schedule(key: str) -> Optional[dict]:
    """Stored per-tile count arrays (float64) plus n_tiles/capacity/K."""
    path = _schedule_path(key)
    if path is None:
        return None
    d = _load_npz(path)
    if d is None or any(f not in d for f in _SCHEDULE_FIELDS):
        _count("schedule_misses")
        return None
    out = {f: d[f].astype(np.float64, copy=False) for f in _SCHEDULE_FIELDS}
    for scalar in ("n_tiles", "capacity", "K"):
        if scalar not in d:
            _count("schedule_misses")
            return None
        out[scalar] = int(d[scalar])
    _count("schedule_hits")
    return out


def store_schedule(key: str, *, n_tiles: int, capacity: int, K: int,
                   vertex_counts, edge_counts, halo_counts,
                   remote_edge_counts) -> bool:
    path = _schedule_path(key)
    if path is None:
        return False
    try:
        _atomic_savez(
            path,
            n_tiles=np.asarray(int(n_tiles), dtype=np.int64),
            capacity=np.asarray(int(capacity), dtype=np.int64),
            K=np.asarray(int(K), dtype=np.int64),
            vertex_counts=np.asarray(vertex_counts, dtype=np.float64),
            edge_counts=np.asarray(edge_counts, dtype=np.float64),
            halo_counts=np.asarray(halo_counts, dtype=np.float64),
            remote_edge_counts=np.asarray(remote_edge_counts,
                                          dtype=np.float64),
        )
    except OSError:
        return False
    _count("schedule_stores")
    return True
