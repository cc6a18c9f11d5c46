"""Composition layer: from one tile-layer to L-layer, full-graph totals (a
copy of the reference's ``repro/core/compose.py``, homogeneous part).

The paper's Tables III/IV model one GNN layer over one graph tile.  This
module composes any registered dataflow upward:

* :class:`MultiLayerModel` chains L GNN layers, propagating the feature
  width, with an inter-layer residency policy: ``"spill"`` (every layer
  writes its outputs off-array and the next reloads them) or ``"resident"``
  (interior outputs stay on-array, charged as one ``residenthandoff`` term).
* :class:`TiledGraphModel` covers a full graph: a tile schedule is derived
  from (V, E) and the tile vertex capacity, every tile re-evaluates the
  inner model, and a ``haloreload`` term charges re-fetching remote source
  features.  Passing a :class:`~repro_torch.core.trace.GraphTrace` swaps
  the uniform approximation for the exact edge-list schedule, whose halo
  and cut counts come from kernel K4 on ``device``.

All arithmetic is float64 closed form on the host, broadcasting, in the
reference's operation order, so totals are bit-identical to it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .dataflow import DataflowSpec, SpecModel
from .notation import GraphTileParams, ParamArray
from .terms import ModelOutput, MovementTerm, ceil
from .trace import GraphTrace, TraceSchedule

__all__ = [
    "MultiLayerModel",
    "TiledGraphModel",
    "FullGraphParams",
    "RESIDENCY_POLICIES",
    "tile_working_set_bits",
]

RESIDENCY_POLICIES = ("spill", "resident")

#: Tile-axis chunk for the capacity-batched trace evaluation.  MUST stay a
#: power of two: the pairwise reduction tree then decomposes into aligned
#: subtrees, so chunked partial sums combine bit-identically to one
#: unchunked pairwise pass (and to every per-capacity pass).
TRACE_TILE_CHUNK = 1 << 16


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _pairwise_sum(a: np.ndarray) -> np.ndarray:
    """Sum over the last axis by pairwise halving (deterministic tree).

    A schedule of ``2^k`` identical tiles sums bit-identically to the
    uniform closed form's ``n_tiles * per_tile`` product (every halving
    step doubles an exactly-representable value).  Zero-padding to even
    length is exact.
    """
    a = _f64(a)
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = np.concatenate(
                [a, np.zeros(a.shape[:-1] + (1,), dtype=np.float64)], axis=-1)
        a = a[..., 0::2] + a[..., 1::2]
    return a[..., 0]


def _resolve_spec(dataflow) -> DataflowSpec:
    if isinstance(dataflow, str):
        from . import registry
        return registry.get(dataflow)
    if isinstance(dataflow, DataflowSpec):
        return dataflow
    if isinstance(dataflow, SpecModel):
        return dataflow.spec
    raise TypeError(f"cannot resolve a DataflowSpec from {type(dataflow).__name__}")


class _TermAccumulator:
    """Sum (bits, iterations) contributions by (name, hierarchy), in order."""

    def __init__(self) -> None:
        self._order: list[tuple[str, str]] = []
        self._bits: dict[tuple[str, str], np.ndarray] = {}
        self._iters: dict[tuple[str, str], np.ndarray] = {}

    def add(self, name: str, hierarchy: str, bits, iterations) -> None:
        key = (name, hierarchy)
        if key not in self._bits:
            self._order.append(key)
            self._bits[key] = _f64(bits)
            self._iters[key] = _f64(iterations)
        else:
            self._bits[key] = self._bits[key] + _f64(bits)
            self._iters[key] = self._iters[key] + _f64(iterations)

    def terms(self) -> tuple[MovementTerm, ...]:
        return tuple(MovementTerm(n, h, self._bits[(n, h)], self._iters[(n, h)])
                     for n, h in self._order)


class MultiLayerModel:
    """L chained GNN layers of one dataflow, with width propagation.

    ``widths`` is the per-vertex feature-element sequence ``[N_0, ..., N_L]``;
    layer l evaluates the inner dataflow at ``N = widths[l], T =
    widths[l+1]`` on the same tile topology.  ``"spill"`` sums the layers;
    ``"resident"`` drops interior ``vertex_out``/``vertex_in`` levels for
    one ``residenthandoff`` L1-L1 term of ``K * widths[l+1] * sigma`` bits
    per boundary.
    """

    def __init__(self, dataflow, widths, *, residency: str = "spill") -> None:
        self.spec = _resolve_spec(dataflow)
        if len(widths) < 2:
            raise ValueError(f"need >= 2 widths (got {list(widths)}): "
                             "a layer maps widths[l] -> widths[l+1]")
        if residency not in RESIDENCY_POLICIES:
            raise ValueError(f"unknown residency {residency!r}; "
                             f"expected one of {RESIDENCY_POLICIES}")
        self.widths = tuple(widths)
        self.residency = residency
        self.name = f"{self.spec.name}_L{self.n_layers}_{residency}"

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    def resolve_hw(self, hw=None):
        return self.spec.resolve_hw(hw)

    def halo_feature_elems(self) -> np.ndarray:
        """Per-vertex elements fetched across tile boundaries, all layers."""
        return _f64(sum(_f64(w) for w in self.widths[:-1]))

    def evaluate(self, graph: GraphTileParams, hw=None) -> ModelOutput:
        hw = self.resolve_hw(hw)
        L = self.n_layers
        acc = _TermAccumulator()
        for l in range(L):
            g_l = graph.replace(N=self.widths[l], T=self.widths[l + 1])
            for m in self.spec.movements:
                if self.residency == "resident" and m.interior_at(l, L):
                    continue
                bits, iters = m.form(g_l, hw)
                acc.add(m.name, m.hierarchy, bits, iters)
        if self.residency == "resident":
            K = _f64(graph.K)
            s = _f64(hw.sigma)
            for l in range(L - 1):
                acc.add("residenthandoff", "L1-L1",
                        K * _f64(self.widths[l + 1]) * s, np.ones_like(K))
        return ModelOutput(
            accelerator=self.name,
            terms=acc.terms(),
            meta={"hw": hw, "graph": graph, "spec": self.spec,
                  "widths": self.widths, "residency": self.residency},
        )


def tile_working_set_bits(tile_vertices, *, V, widths, sigma,
                          residency: str = "spill", halo_dedup=1.0):
    """Closed-form on-chip working set (bits) of one tile pass.

    * weights: ``sigma * sum_l widths[l] * widths[l+1]``;
    * activations for the tile's ``K = ceil(V / ceil(V / tile_vertices))``
      vertices: ``"spill"`` peaks at ``K * max_l (widths[l] +
      widths[l+1])``, ``"resident"`` holds ``K * sum(widths)``;
    * a halo-dedup cache of ``K * widths[0] * (1 - 1/halo_dedup)``.

    ``K`` uses the geometry of :meth:`TiledGraphModel.tile_schedule` and
    ``GraphTrace._geometry``.
    """
    if residency not in RESIDENCY_POLICIES:
        raise ValueError(f"unknown residency {residency!r}; "
                         f"expected one of {RESIDENCY_POLICIES}")
    w = [_f64(x) for x in widths]
    if len(w) < 2:
        raise ValueError(f"need >= 2 widths (got {list(widths)}): "
                         "a layer maps widths[l] -> widths[l+1]")
    tv = _f64(tile_vertices)
    if not np.all(np.isfinite(tv)) or np.any(tv < 1):
        raise ValueError(f"tile_vertices must be >= 1, got {tile_vertices!r}")
    hd = _f64(halo_dedup)
    if not np.all(np.isfinite(hd)) or np.any(hd < 1.0):
        raise ValueError(f"halo_dedup must be finite and >= 1, "
                         f"got {halo_dedup!r}")
    Vv = _f64(V)
    n_tiles = np.maximum(ceil(Vv / tv), 1.0)
    K = ceil(Vv / n_tiles)
    weight_elems = _f64(0.0)
    for l in range(len(w) - 1):
        weight_elems = weight_elems + w[l] * w[l + 1]
    if residency == "resident":
        act_elems = _f64(0.0)
        for wl in w:
            act_elems = act_elems + wl
    else:
        act_elems = w[0] + w[1]
        for l in range(1, len(w) - 1):
            act_elems = np.maximum(act_elems, w[l] + w[l + 1])
    halo_elems = w[0] * (1.0 - 1.0 / hd)
    return _f64(sigma) * (weight_elems + K * (act_elems + halo_elems))


@dataclass(frozen=True)
class FullGraphParams:
    """A whole (untiled) graph plus the layer-level feature widths.

    Attributes:
      V: total vertex count.
      E: total edge count.
      N: input feature width (elements per vertex).
      T: output feature width.  A MultiLayerModel's ``widths`` supersede
         N/T.
      high_degree_fraction: fraction of each tile's vertices served by a
         dedicated degree-aware cache (EnGN's L; L = K/10 by default).
    """

    V: ParamArray
    E: ParamArray
    N: ParamArray
    T: ParamArray
    high_degree_fraction: ParamArray = 0.1

    def __post_init__(self) -> None:
        for field in ("V", "E", "N", "T", "high_degree_fraction"):
            val = _f64(getattr(self, field))
            if not np.all(np.isfinite(val)):
                raise ValueError(f"FullGraphParams.{field} must be finite, "
                                 f"got {getattr(self, field)!r}")
            if np.any(val < 0):
                raise ValueError(
                    f"FullGraphParams.{field} must be non-negative "
                    f"(got {getattr(self, field)!r}); a negative value "
                    "would silently produce negative movement totals")
        hdf = _f64(self.high_degree_fraction)
        if np.any(hdf > 1.0):
            raise ValueError(
                f"FullGraphParams.high_degree_fraction is a fraction of the "
                f"tile's vertices and must be <= 1 "
                f"(got {self.high_degree_fraction!r})")

    def replace(self, **kw) -> "FullGraphParams":
        # dataclasses.replace re-runs __post_init__.
        return dataclasses.replace(self, **kw)


class TiledGraphModel:
    """Sum a per-tile model over the tile schedule of a full graph.

    The uniform schedule slices V vertices into ``n_tiles = ceil(V /
    tile_vertices)`` balanced tiles of ``K = ceil(V / n_tiles)`` vertices
    and ``P = ceil(E / n_tiles)`` edges, and ``haloreload`` charges the
    random-partition cut ``E (1 - 1/n_tiles)`` divided by ``halo_dedup``.

    Passing ``trace`` replaces both approximations with the edge list's
    exact schedule: each tile is evaluated at its own ``(K_t, L_t, P_t)``
    over a trailing tile axis, and ``haloreload`` charges the exact unique
    remote sources, so ``halo_dedup`` must stay 1.  ``tile_vertices`` may
    then be a scalar or a 1-D array of capacities (the capacity axis): row
    ``b`` is bit-identical to a scalar evaluation at ``tile_vertices[b]``.
    The trace's schedules come from ``trace.schedules(..., device=device)``:
    kernel K4 on CUDA unless ``device="cpu"``.  Passing ``schedule`` (an
    explicit :class:`TraceSchedule`) evaluates those tiles as given.
    """

    def __init__(self, inner, *, tile_vertices: ParamArray = 1024,
                 halo_dedup: ParamArray = 1.0,
                 trace: GraphTrace | None = None,
                 schedule: TraceSchedule | None = None,
                 device=None) -> None:
        if isinstance(inner, MultiLayerModel):
            self.inner = inner
        else:
            spec = _resolve_spec(inner)
            self.inner = SpecModel(spec)
        if schedule is not None:
            # Explicit-schedule mode: the capacity is the schedule's.
            if trace is not None:
                raise ValueError("pass either trace or schedule, not both: "
                                 "an explicit schedule already carries its "
                                 "exact per-tile counts")
            if not isinstance(schedule, TraceSchedule):
                raise TypeError(f"schedule must be a TraceSchedule, "
                                f"got {type(schedule).__name__}")
            tile_vertices = schedule.capacity
        tv = _f64(tile_vertices)
        if not np.all(np.isfinite(tv)) or np.any(tv < 1):
            raise ValueError(
                f"tile_vertices must be >= 1 (got {tile_vertices!r}): a tile "
                "holds at least one vertex, and zero/negative capacities "
                "silently produce nonsense schedules")
        self.tile_vertices = tile_vertices
        hd = _f64(halo_dedup)
        if not np.all(np.isfinite(hd)) or np.any(hd < 1.0):
            raise ValueError(
                f"halo_dedup must be finite and >= 1 (it divides halo "
                f"traffic), got {halo_dedup!r}")
        self.halo_dedup = hd
        if trace is not None:
            if not isinstance(trace, GraphTrace):
                raise TypeError(f"trace must be a GraphTrace, "
                                f"got {type(trace).__name__}")
            if tv.ndim > 1:
                raise ValueError(
                    "tile capacities with a trace must be a scalar or a "
                    "1-D array (one capacity per batch member): the "
                    "capacity axis becomes the leading batch axis of the "
                    "evaluation")
        if (trace is not None or schedule is not None) and np.any(hd != 1.0):
            raise ValueError(
                "halo_dedup must be 1 with a trace or an explicit "
                "schedule: the exact schedule already deduplicates remote "
                "sources per tile (unique-source halo counts), so an "
                "extra divisor would double-count the dedup")
        self.trace = trace
        self.schedule = schedule
        self.device = device
        inner_name = getattr(self.inner, "name", type(self.inner).__name__)
        kind = ("episode" if schedule is not None
                else "trace" if trace is not None else "tiled")
        self.name = f"{inner_name}_{kind}"

    def resolve_hw(self, hw=None):
        return self.inner.spec.resolve_hw(hw)

    def tile_schedule(self, full: FullGraphParams) -> tuple[np.ndarray, GraphTileParams]:
        """(n_tiles, per-tile GraphTileParams) for the full graph."""
        V, E = _f64(full.V), _f64(full.E)
        n_tiles = np.maximum(ceil(V / _f64(self.tile_vertices)), 1.0)
        K = ceil(V / n_tiles)
        return n_tiles, GraphTileParams(
            N=_f64(full.N),
            T=_f64(full.T),
            K=K,
            L=np.floor(K * full.high_degree_fraction),
            P=ceil(E / n_tiles),
        )

    def _halo_width(self) -> np.ndarray:
        if isinstance(self.inner, MultiLayerModel):
            return self.inner.halo_feature_elems()
        return None  # use the full graph's N

    # -- exact (trace-driven) schedule ------------------------------------
    def _promoted_inner(self):
        """Inner model with every numeric leaf given a trailing singleton
        axis, so batch/sweep axes broadcast against the tile axis."""
        if isinstance(self.inner, MultiLayerModel):
            widths = tuple(_f64(w)[..., None] for w in self.inner.widths)
            return MultiLayerModel(self.inner.spec, widths,
                                   residency=self.inner.residency)
        return self.inner

    @staticmethod
    def _promoted_hw(hw):
        """Hardware record with a trailing singleton axis on every field."""
        kw = {f.name: _f64(getattr(hw, f.name))[..., None]
              for f in dataclasses.fields(hw)
              if getattr(hw, f.name) is not None}
        return hw.replace(**kw)

    def _evaluate_trace_multi(self, full: FullGraphParams, hw) -> ModelOutput:
        """Capacity-axis evaluation: one batched call over B capacities.

        The per-capacity tile axes are right-padded to the longest, masked
        (padded tiles contribute exactly 0.0), and reduced in power-of-two
        chunks with the same pairwise tree, so row ``b`` is bit-identical
        to a scalar-capacity evaluation at ``tile_vertices[b]``.
        """
        tr = self.trace
        caps = np.asarray(self.tile_vertices)
        scheds = tr.schedules([c for c in caps.tolist()], device=self.device)
        B = len(scheds)
        M = max(s.n_tiles for s in scheds)
        K_pad = np.zeros((B, M), dtype=np.float64)
        P_pad = np.zeros((B, M), dtype=np.float64)
        mask = np.zeros((B, M), dtype=np.float64)
        for b, s in enumerate(scheds):
            m = s.n_tiles
            K_pad[b, :m] = s.vertex_counts
            P_pad[b, :m] = s.edge_counts
            mask[b, :m] = 1.0
        N = _f64(full.N)[..., None]
        T = _f64(full.T)[..., None]
        hdf = _f64(full.high_degree_fraction)[..., None]
        inner = self._promoted_inner()
        phw = self._promoted_hw(hw)
        order: list[tuple[str, str]] = []
        partial_bits: dict[tuple[str, str], list] = {}
        partial_iters: dict[tuple[str, str], list] = {}
        for start in range(0, M, TRACE_TILE_CHUNK):
            sl = slice(start, start + TRACE_TILE_CHUNK)
            K_c = K_pad[:, sl]
            tile_c = GraphTileParams(N=N, T=T, K=K_c,
                                     L=np.floor(K_c * hdf), P=P_pad[:, sl])
            out_c = inner.evaluate(tile_c, phw)
            m_c = mask[:, sl]
            for t in out_c.terms:
                key = (t.name, t.hierarchy)
                if key not in partial_bits:
                    order.append(key)
                    partial_bits[key] = []
                    partial_iters[key] = []
                # The mask multiply zeroes padded tiles exactly (the
                # closed forms never divide by a graph field, so padded
                # values are finite) and is the identity on real tiles.
                partial_bits[key].append(
                    _pairwise_sum(_f64(t.data_bits) * m_c))
                partial_iters[key].append(
                    _pairwise_sum(_f64(t.iterations) * m_c))
        terms = [
            MovementTerm(name, hier,
                         _pairwise_sum(np.stack(partial_bits[(name, hier)],
                                                axis=-1)),
                         _pairwise_sum(np.stack(partial_iters[(name, hier)],
                                                axis=-1)))
            for name, hier in order]
        width = self._halo_width()
        if width is None:
            width = _f64(full.N)
        halo_totals = _f64([s.halo_total for s in scheds])
        halo_bits = halo_totals * width * _f64(hw.sigma)
        halo_iters = ceil(halo_bits / _f64(hw.B))
        terms.append(MovementTerm("haloreload", "L2-L1", halo_bits, halo_iters))
        return ModelOutput(
            accelerator=self.name,
            terms=tuple(terms),
            meta={"hw": hw, "graph": full,
                  "n_tiles": _f64([s.n_tiles for s in scheds]),
                  "schedules": scheds, "inner": self.inner, "trace": tr},
        )

    def _evaluate_trace(self, full: FullGraphParams, hw) -> ModelOutput:
        hw = self.resolve_hw(hw)
        tr = self.trace
        if np.any(_f64(full.V) != tr.n_nodes) or np.any(_f64(full.E) != tr.n_edges):
            raise ValueError(
                f"FullGraphParams (V={full.V!r}, E={full.E!r}) does not "
                f"match the trace (V={tr.n_nodes}, E={tr.n_edges}); a trace "
                "schedule is exact, so the declared graph must be the "
                "traced graph")
        if np.asarray(self.tile_vertices).ndim == 1:
            return self._evaluate_trace_multi(full, hw)
        sched = tr.schedule(self.tile_vertices, device=self.device)
        return self._evaluate_one_schedule(full, hw, sched,
                                           {"trace": tr})

    def _evaluate_schedule(self, full: FullGraphParams, hw) -> ModelOutput:
        """Explicit-schedule mode: the given schedule's tiles, its halo
        counts charged like the trace path's halo reload."""
        hw = self.resolve_hw(hw)
        sched = self.schedule
        if np.any(_f64(full.E) != _f64(sched.n_edges)):
            raise ValueError(
                f"FullGraphParams.E={full.E!r} does not match the explicit "
                f"schedule's total edge count {sched.n_edges}; an explicit "
                "schedule is exact, so the declared edge total must be the "
                "measured one")
        return self._evaluate_one_schedule(full, hw, sched, {})

    def _evaluate_one_schedule(self, full: FullGraphParams, hw,
                               sched: TraceSchedule,
                               meta_extra: dict) -> ModelOutput:
        m = sched.n_tiles
        # Tile axis is the LAST axis: every non-tile numeric leaf gets a
        # trailing singleton so sweeps/batches broadcast against it.
        K_t = _f64(sched.vertex_counts)
        hdf = _f64(full.high_degree_fraction)[..., None]
        tile = GraphTileParams(
            N=_f64(full.N)[..., None],
            T=_f64(full.T)[..., None],
            K=K_t,
            L=np.floor(K_t * hdf),
            P=_f64(sched.edge_counts),
        )
        per_tile = self._promoted_inner().evaluate(tile, self._promoted_hw(hw))

        # Pairwise tile-axis reduction: bit-identical to the uniform path's
        # `n_tiles * per_tile` product when all tiles are equal and n_tiles
        # is a power of two (the ring bit-match invariant).
        def collapse(x):
            a = _f64(x)
            return _pairwise_sum(np.broadcast_to(
                a, np.broadcast_shapes(a.shape, (m,))))

        terms = [MovementTerm(t.name, t.hierarchy,
                              collapse(t.data_bits), collapse(t.iterations))
                 for t in per_tile.terms]
        width = self._halo_width()
        if width is None:
            width = _f64(full.N)
        halo_bits = _f64(sched.halo_total) * width * _f64(hw.sigma)
        halo_iters = ceil(halo_bits / _f64(hw.B))
        terms.append(MovementTerm("haloreload", "L2-L1", halo_bits, halo_iters))
        return ModelOutput(
            accelerator=self.name,
            terms=tuple(terms),
            meta={"hw": hw, "graph": full, "n_tiles": float(m), "tile": tile,
                  "inner": self.inner, "schedule": sched, **meta_extra},
        )

    def evaluate(self, full: FullGraphParams, hw=None) -> ModelOutput:
        if self.schedule is not None:
            return self._evaluate_schedule(full, hw)
        if self.trace is not None:
            return self._evaluate_trace(full, hw)
        hw = self.resolve_hw(hw)
        n_tiles, tile = self.tile_schedule(full)
        per_tile = self.inner.evaluate(tile, hw)
        terms = list(per_tile.scaled(n_tiles).terms)
        width = self._halo_width()
        if width is None:
            width = _f64(full.N)
        cut_edges = _f64(full.E) * (1.0 - 1.0 / n_tiles)
        halo_bits = cut_edges * width * _f64(hw.sigma) / self.halo_dedup
        halo_iters = ceil(halo_bits / _f64(hw.B))
        terms.append(MovementTerm("haloreload", "L2-L1", halo_bits, halo_iters))
        return ModelOutput(
            accelerator=self.name,
            terms=tuple(terms),
            meta={"hw": hw, "graph": full, "n_tiles": n_tiles,
                  "tile": tile, "inner": self.inner},
        )
