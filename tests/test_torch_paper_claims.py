"""The paper's Sec. IV claims on the port (the twin of
``tests/test_paper_claims.py``).

Each test pins one statement of Sec. IV to the port's closed forms at the
published defaults (N=30, T=5, B=1000, sigma=4, P=10K), and holds the
numbers it reads to the JAX reference's bit for bit.
"""

import numpy as np
import pytest

from repro.core import EnGNModel as JEnGNModel
from repro.core import HyGCNModel as JHyGCNModel
from repro.core import EnGNHardwareParams as JEnGNHW
from repro.core import HyGCNHardwareParams as JHyGCNHW
from repro.core import paper_default_graph as j_graph
from repro.core import sweep as jsweep
from repro_torch.core import (EnGNHardwareParams, EnGNModel,
                              HyGCNHardwareParams, HyGCNModel,
                              paper_default_graph)
from repro_torch.core.sweep import (fig3_engn_movement, fig4_hygcn_movement,
                                    fig5_iterations_vs_bandwidth,
                                    fig6_fitting_factor, fig7_systolic_reuse)

ENGN = EnGNModel()
HYGCN = HyGCNModel()


def _same(got, expect):
    """Every term of two model outputs, bit for bit."""
    assert got.names() == expect.names()
    for t in got.terms:
        assert t.hierarchy == expect[t.name].hierarchy
        np.testing.assert_array_equal(t.data_bits, expect[t.name].data_bits)
        np.testing.assert_array_equal(t.iterations, expect[t.name].iterations)


def _same_sweep(got, expect):
    assert list(got.axes) == list(expect.axes)
    for key in ("data_bits", "iterations"):
        a, b = getattr(got, key), getattr(expect, key)
        assert list(a) == list(b)
        for name in a:
            assert a[name].dtype == b[name].dtype == np.float64
            assert np.array_equal(a[name], b[name]), (key, name)


# ---------------------------------------------------------------------------
# Claim 1 — "aggregation dominates and leads to over 10x more data movement
# than loadvertL2" (Sec. IV-A).
# ---------------------------------------------------------------------------
def test_engn_aggregate_dominates_loadvert():
    out = ENGN.evaluate(paper_default_graph(1024.0), EnGNHardwareParams())
    _same(out, JEnGNModel().evaluate(j_graph(1024.0), JEnGNHW()))
    ratio = float(out["aggregate"].data_bits / out["loadvertL2"].data_bits)
    assert ratio > 10.0, f"aggregate/loadvertL2 = {ratio:.2f}, paper claims > 10x"


def test_engn_aggregate_dominates_across_sweep():
    M = np.array([4, 8, 16, 64, 128, 256], dtype=np.float64)
    out = ENGN.evaluate(paper_default_graph(1024.0),
                        EnGNHardwareParams(M=M, M_prime=M))
    _same(out, JEnGNModel().evaluate(j_graph(1024.0), JEnGNHW(M=M, M_prime=M)))
    assert np.all(out["aggregate"].data_bits > out["loadvertL2"].data_bits)


def test_engn_aggregate_is_onchip_class():
    out = ENGN.evaluate(paper_default_graph(1024.0))
    assert out["aggregate"].hierarchy == "L1-L1"


# ---------------------------------------------------------------------------
# Claim 2 — EnGN movement is linear in K but non-monotone in M.
# ---------------------------------------------------------------------------
def _r2(x, y) -> float:
    pred = np.polyval(np.polyfit(x, y, 1), x)
    return 1.0 - np.sum((y - pred) ** 2) / np.sum((y - y.mean()) ** 2)


def test_engn_linear_in_K():
    K = np.array([256, 512, 1024, 2048, 4096, 8192], dtype=np.float64)
    total = ENGN.evaluate(paper_default_graph(K)).total_bits()
    np.testing.assert_array_equal(
        total, JEnGNModel().evaluate(j_graph(K)).total_bits())
    assert _r2(K, total) > 0.99


def test_engn_nonmonotone_in_M():
    M = np.array([4, 8, 16, 32, 64, 128, 256], dtype=np.float64)
    total = ENGN.evaluate(paper_default_graph(1024.0),
                          EnGNHardwareParams(M=M, M_prime=M)).total_bits()
    best = int(np.argmin(total))
    assert 0 < best < len(M) - 1, f"optimum must be interior: {total}"


# ---------------------------------------------------------------------------
# Claim 3 — HyGCN movement is linear in K and its off-chip terms are
# independent of the array size (Sec. IV-B).
# ---------------------------------------------------------------------------
def test_hygcn_linear_in_K():
    K = np.array([256, 512, 1024, 2048, 4096, 8192], dtype=np.float64)
    total = HYGCN.evaluate(paper_default_graph(K)).total_bits()
    np.testing.assert_array_equal(
        total, JHyGCNModel().evaluate(j_graph(K)).total_bits())
    assert _r2(K, total) > 0.99


def test_hygcn_offchip_independent_of_Ma():
    Ma = np.array([8, 16, 32, 64, 128], dtype=np.float64)
    out = HYGCN.evaluate(paper_default_graph(1024.0),
                         HyGCNHardwareParams(Ma=Ma))
    _same(out, JHyGCNModel().evaluate(j_graph(1024.0), JHyGCNHW(Ma=Ma)))
    offchip = out.offchip_bits() + out.total_bits(("L1-L2",))
    spread = (offchip.max() - offchip.min()) / offchip.mean()
    assert spread < 1e-9, f"off-chip movement varies with Ma: {offchip}"


# ---------------------------------------------------------------------------
# Claim 4 — HyGCN moves more off-chip data than EnGN, through its
# inter-phase buffer (Sec. IV-B).
# ---------------------------------------------------------------------------
def test_hygcn_moves_more_offchip_than_engn():
    g = paper_default_graph(1024.0)
    engn_off = float(ENGN.evaluate(g).offchip_bits())
    hygcn_off = float(HYGCN.evaluate(g).offchip_bits())
    assert (engn_off, hygcn_off) == (
        float(JEnGNModel().evaluate(j_graph(1024.0)).offchip_bits()),
        float(JHyGCNModel().evaluate(j_graph(1024.0)).offchip_bits()))
    assert hygcn_off > engn_off
    out = HYGCN.evaluate(g)
    interphase = float(out["writeinterphase"].data_bits
                       + out["readinterphase"].data_bits)
    assert interphase > 0.5 * (hygcn_off - engn_off)


def test_engn_loadvertL2_smaller_than_hygcn():
    """Compared at matched PE-array sizes (M = Ma)."""
    g = paper_default_graph(1024.0)
    sizes = np.array([8, 16, 32, 64], dtype=np.float64)
    engn = ENGN.evaluate(g, EnGNHardwareParams(M=sizes, M_prime=sizes)
                         )["loadvertL2"].data_bits
    hygcn = HYGCN.evaluate(g, HyGCNHardwareParams(Ma=sizes)
                           )["loadvertL2"].data_bits
    assert np.all(engn <= hygcn), (engn, hygcn)
    assert np.any(engn < hygcn)


# ---------------------------------------------------------------------------
# Claim 5 — bandwidth saturation: EnGN's saturation point grows with the
# tile size; HyGCN's iterations fall with bandwidth.
# ---------------------------------------------------------------------------
def _saturation_B(res, k_index: int, tol: float = 1.05) -> float:
    iters = res.total_iterations[:, k_index]
    B = res.axes["B"]
    return float(B[np.argmax(iters <= tol * iters.min())])


def test_engn_saturation_point_grows_with_tile():
    res = fig5_iterations_vs_bandwidth("engn")
    _same_sweep(res, jsweep.fig5_iterations_vs_bandwidth("engn"))
    sats = [_saturation_B(res, i) for i in range(len(res.axes["K"]))]
    assert sats == sorted(sats), sats
    assert sats[-1] > sats[0]


def test_hygcn_iterations_decrease_with_bandwidth():
    res = fig5_iterations_vs_bandwidth("hygcn")
    _same_sweep(res, jsweep.fig5_iterations_vs_bandwidth("hygcn"))
    assert np.all(np.diff(res.total_iterations, axis=0) <= 1e-9)


# ---------------------------------------------------------------------------
# Claim 6 — HyGCN loadweights scales with (1 - Gamma) (Fig. 7).
# ---------------------------------------------------------------------------
def test_hygcn_gamma_suppresses_loadweights():
    res = fig7_systolic_reuse()
    _same_sweep(res, jsweep.fig7_systolic_reuse())
    lw = res.data_bits["loadweights"]
    assert np.all(np.diff(lw, axis=0) <= 1e-9)
    assert lw[-1].max() < lw[0].min()


def test_hygcn_loadweights_grows_with_depth_N():
    lw = fig7_systolic_reuse().data_bits["loadweights"]
    assert np.all(np.diff(lw, axis=1) >= -1e-9)


# ---------------------------------------------------------------------------
# Claim 7 — EnGN iterations jump once the fitting factor K*N/M^2 exceeds 1
# (Fig. 6).
# ---------------------------------------------------------------------------
def test_engn_fitting_factor_knee():
    res = fig6_fitting_factor()
    ref = jsweep.fig6_fitting_factor()
    _same_sweep(res, ref)
    ff = np.asarray(res.meta["fitting_factor"])
    np.testing.assert_array_equal(ff, ref.meta["fitting_factor"])
    iters = res.total_iterations
    over, under = iters[ff > 1.0], iters[ff <= 1.0]
    assert over.min() > under.max() * 0.99
    assert over.max() > under.max()
    assert np.all(np.diff(iters[np.argsort(ff)]) >= -1e-9)


# ---------------------------------------------------------------------------
# Structural checks on the sweep engine itself.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn,ref,naxes", [
    (fig3_engn_movement, jsweep.fig3_engn_movement, 2),
    (fig4_hygcn_movement, jsweep.fig4_hygcn_movement, 2),
    (fig6_fitting_factor, jsweep.fig6_fitting_factor, 1),
    (fig7_systolic_reuse, jsweep.fig7_systolic_reuse, 2),
], ids=["fig3", "fig4", "fig6", "fig7"])
def test_sweep_shapes(fn, ref, naxes):
    res = fn()
    assert len(res.axes) == naxes
    shape = tuple(len(v) for v in res.axes.values())
    assert np.broadcast_to(res.total_bits, shape).shape == shape
    rows = res.rows()
    assert len(rows) == int(np.prod(shape))
    assert all(np.isfinite(r["total_bits"]) for r in rows)
    assert rows == ref().rows()
