"""The property battery of the reference (``tests/test_properties.py``),
pointed at the port's closed forms and composition layer.

* every registered dataflow produces finite, non-negative bits and
  iterations (equal to the reference's, bit for bit), monotone
  non-decreasing in tile vertices (K <-> V), edges (P <-> E) and feature
  width (N);
* ``MultiLayerModel`` with L=1 and ``"spill"`` residency is the base spec,
  per term, bit for bit;
* ``TiledGraphModel`` with tile capacity >= V degenerates to one tile with
  zero halo-reload bits.

Runs under hypothesis when installed; otherwise a deterministic shim draws
seeded samples from the same strategy ranges.
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # deterministic fallback: same shapes, seeded draws
    HAVE_HYPOTHESIS = False

    class _IntStrategy:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def draw(self, rng):
            return int(rng.integers(self.lo, self.hi + 1))

    class _SampledStrategy:
        def __init__(self, elems):
            self.elems = list(elems)

        def draw(self, rng):
            return self.elems[int(rng.integers(len(self.elems)))]

    class st:  # noqa: N801 - mirrors the hypothesis namespace
        integers = staticmethod(lambda lo, hi: _IntStrategy(lo, hi))
        sampled_from = staticmethod(_SampledStrategy)

    def settings(**_kw):
        return lambda fn: fn

    def given(*strategies, n_examples=12):
        """Like hypothesis.given: strategies fill the test's trailing
        parameters (by name, so pytest.parametrize kwargs compose)."""
        def deco(fn):
            import functools
            import inspect

            sig_params = list(inspect.signature(fn).parameters.values())
            drawn = [p.name for p in sig_params[len(sig_params) - len(strategies):]]

            @functools.wraps(fn)
            def wrapper(**kwargs):
                rng = np.random.default_rng(0)
                for _ in range(n_examples):
                    fn(**kwargs,
                       **{nm: s.draw(rng) for nm, s in zip(drawn, strategies)})

            # hide the drawn parameters from pytest's fixture resolution
            wrapper.__signature__ = inspect.Signature(
                [p for p in sig_params if p.name not in drawn])
            return wrapper
        return deco

from repro.core import registry as jregistry
from repro.core.notation import paper_default_graph as j_paper_graph
from repro_torch.core import (FullGraphParams, MultiLayerModel,
                              TiledGraphModel, paper_default_graph, registry)

ALL_DATAFLOWS = registry.names()


def _point(rng_k, n, t):
    return paper_default_graph(float(rng_k)).replace(N=float(n), T=float(t))


def _totals(name, graph):
    out = registry.evaluate(name, graph)
    return float(out.total_bits()), float(out.total_iterations())


# ---------------------------------------------------------------------------
# Finite, non-negative movement at arbitrary operating points.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL_DATAFLOWS)
@settings(max_examples=20, deadline=None)
@given(st.integers(1, 1 << 20), st.integers(1, 4096), st.integers(1, 512))
def test_movement_finite_and_nonnegative(name, K, N, T):
    out = registry.evaluate(name, _point(K, N, T))
    ref = jregistry.evaluate(name, j_paper_graph(float(K)).replace(
        N=float(N), T=float(T)))
    assert out.names() == ref.names()
    for term in out.terms:
        assert float(term.data_bits) == float(ref[term.name].data_bits)
        assert float(term.iterations) == float(ref[term.name].iterations)
        assert np.all(np.isfinite(term.data_bits)), (name, term.name)
        assert np.all(np.isfinite(term.iterations)), (name, term.name)
        assert np.all(term.data_bits >= 0), (name, term.name)
        assert np.all(term.iterations >= 0), (name, term.name)


# ---------------------------------------------------------------------------
# Monotone non-decreasing in vertices, edges, and feature width.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL_DATAFLOWS)
@pytest.mark.parametrize("param", ["K", "P", "N"])
@settings(max_examples=15, deadline=None)
@given(st.integers(2, 1 << 16), st.integers(2, 1024), st.integers(1, 12))
def test_movement_monotone(name, param, K, N, factor):
    base = _point(K, N, 8)
    bigger = base.replace(**{param: float(getattr(base, param)) * factor})
    b0, i0 = _totals(name, base)
    b1, i1 = _totals(name, bigger)
    assert b1 >= b0, (name, param, K, N, factor)
    assert i1 >= i0, (name, param, K, N, factor)


# ---------------------------------------------------------------------------
# Composition-layer identities.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL_DATAFLOWS)
@settings(max_examples=10, deadline=None)
@given(st.integers(2, 1 << 14), st.integers(1, 512), st.integers(1, 256))
def test_single_layer_spill_is_base_spec(name, K, N, T):
    """MultiLayerModel(L=1, spill) == the base spec, per term, exactly."""
    graph = _point(K, N, T)
    base = registry.evaluate(name, graph)
    ml = MultiLayerModel(name, [N, T], residency="spill").evaluate(graph)
    assert ml.names() == base.names()
    for term in base.terms:
        assert float(ml[term.name].data_bits) == float(term.data_bits)
        assert float(ml[term.name].iterations) == float(term.iterations)


@pytest.mark.parametrize("name", ALL_DATAFLOWS)
@settings(max_examples=10, deadline=None)
@given(st.integers(1, 1 << 14), st.integers(0, 1 << 10), st.integers(1, 256))
def test_tile_capacity_at_least_v_degenerates(name, V, extra_cap, N):
    """Capacity >= V: one tile, zero halo-reload bits, totals == inner."""
    full = FullGraphParams(V=V, E=10 * V, N=N, T=8)
    model = TiledGraphModel(name, tile_vertices=V + extra_cap)
    out = model.evaluate(full)
    n_tiles, tile = model.tile_schedule(full)
    assert float(n_tiles) == 1.0
    assert float(tile.K) == float(V)
    assert float(out["haloreload"].data_bits) == 0.0
    inner = registry.evaluate(name, tile)
    assert float(out.total_bits()) == float(inner.total_bits())


def test_all_registered_dataflows_covered():
    """The battery spans the whole registry: the reference's five
    dataflows, in its order."""
    assert ALL_DATAFLOWS == jregistry.names()
    assert len(ALL_DATAFLOWS) >= 5
    assert {"engn", "hygcn", "spmm_tiled", "spmm_unfused",
            "awb_gcn"} <= set(ALL_DATAFLOWS)
