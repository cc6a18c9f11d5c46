"""The port's GNN layer kernels against the JAX reference kernels.

The same numpy inputs, made from a seed, go through the reference ``ops``
(Pallas in interpret mode, as the reference's own tests run it) and the
port's ``ops`` on the CPU, which take the plain versions there.  On the
card the ``gpu``-marked tests hold each CUDA kernel against its plain
version; here they skip.

Tolerances are the reference's (``tests/test_kernels.py``): relative to the
largest output magnitude, 1e-5 for f32 (fp32 sums in another order) and
3e-2 for bf16 (one bf16 rounding of the output, and of the spilled
aggregate in the unfused pair).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.gcn_cora import make_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.gnn import gcn as jgcn
from repro.models.gnn.graph import GraphBatch, sym_norm_coeffs
from repro_torch import backend, data, params
from repro_torch.kernels import edge_aggregate as ea
from repro_torch.kernels import edge_aggregate_unfused as eu
from repro_torch.kernels import build, ops, ref

#: The reference's fused-kernel shapes (n, f, t, block_n, block_k).
SHAPES = [
    (256, 32, 8, 128, 128),
    (512, 64, 16, 128, 256),
    (512, 128, 32, 256, 256),
    (1024, 16, 7, 256, 512),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


def _layer_inputs(n, f, t, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.02).astype(np.float32) * rng.random((n, n))
    return (a.astype(np.float32), rng.standard_normal((n, f)),
            rng.standard_normal((f, t)))


def _both(arrays, key):
    jdt, tdt, tol = DTYPES[key]
    j = [jnp.asarray(v, jdt) for v in arrays]
    t = [torch.as_tensor(np.asarray(v, np.float32)).to(tdt) for v in arrays]
    return j, t, tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Kernel twins on the CPU: port ops vs reference ops.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,f,t,bn,bk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_matches_reference(n, f, t, bn, bk, dtype):
    (ja, jx, jw), (a, x, w), tol = _both(_layer_inputs(n, f, t, n + f), dtype)
    expect = jops.gnn_aggregate_combine(ja, jx, jw, block_n=bn, block_k=bk)
    out = ops.gnn_aggregate_combine(a, x, w, block_n=bn, block_k=bk)
    assert out.dtype == a.dtype and out.shape == (n, t)
    assert _rel(_np(out), _np(expect)) < tol
    assert _rel(_np(out), _np(jref.fused_aggregate_combine_ref(ja, jx, jw))) < tol


@pytest.mark.parametrize("n,f,t,bn,bk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unfused_pair_matches_reference(n, f, t, bn, bk, dtype):
    (ja, jx, jw), (a, x, w), tol = _both(_layer_inputs(n, f, t, n + t), dtype)
    j_agg = jops.gnn_aggregate(ja, jx, block_n=bn, block_k=bk)
    agg = ops.gnn_aggregate(a, x, block_n=bn, block_k=bk)
    assert agg.dtype == a.dtype and agg.shape == (n, f)
    assert _rel(_np(agg), _np(j_agg)) < tol
    expect = jops.gnn_combine(j_agg, jw, block_n=bn)
    out = ops.gnn_combine(agg, w, block_n=bn)
    assert _rel(_np(out), _np(expect)) < tol


def test_fused_matches_edge_list_semantics():
    """Block-dense adjacency path == edge-list index_add_ path == the
    reference's segment_sum path."""
    rng = np.random.default_rng(7)
    n, f, t, e = 256, 24, 8, 900
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    wgt = rng.random(e).astype(np.float32)
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (rcv, snd), wgt)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((f, t)).astype(np.float32)
    agg = ref.edge_list_aggregate_ref(torch.as_tensor(x), torch.as_tensor(snd),
                                      torch.as_tensor(rcv),
                                      torch.as_tensor(wgt), n)
    j_agg = jref.edge_list_aggregate_ref(jnp.asarray(x), jnp.asarray(snd),
                                         jnp.asarray(rcv), jnp.asarray(wgt), n)
    assert _rel(agg.numpy(), np.asarray(j_agg)) < 1e-6
    out = ops.gnn_aggregate_combine(torch.as_tensor(a), torch.as_tensor(x),
                                    torch.as_tensor(w), block_n=128,
                                    block_k=128)
    assert _rel(out.numpy(), agg.numpy() @ w) < 1e-4


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(1, 3))
def test_fused_linearity_matches_reference(nb, kb, seed):
    """f(X1 + X2) == f(X1) + f(X2), and f(X1 + X2) agrees with the
    reference kernel."""
    rng = np.random.default_rng(seed)
    n, f, t = 128 * nb, 16, 8
    bk = 128 * kb if n % (128 * kb) == 0 else n
    a = (rng.random((n, n)) < 0.05).astype(np.float32)
    x1 = rng.standard_normal((n, f)).astype(np.float32)
    x2 = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((f, t)).astype(np.float32)
    fn = lambda x: ops.gnn_aggregate_combine(
        torch.as_tensor(a), torch.as_tensor(x), torch.as_tensor(w),
        block_n=128, block_k=bk).numpy()
    f12 = fn(x1 + x2)
    assert _rel(f12, fn(x1) + fn(x2)) < 1e-4
    expect = jops.gnn_aggregate_combine(jnp.asarray(a), jnp.asarray(x1 + x2),
                                        jnp.asarray(w), block_n=128,
                                        block_k=bk)
    assert _rel(f12, np.asarray(expect)) < 1e-5


# ---------------------------------------------------------------------------
# Wrapper rules.
# ---------------------------------------------------------------------------
def test_kernels_refuse_cpu_tensors():
    a, x, w = (torch.zeros(s) for s in ((256, 256), (256, 16), (16, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ea.fused_aggregate_combine(a, x, w)
    with pytest.raises(ValueError, match="CUDA"):
        eu.aggregate_pass(a, x)
    with pytest.raises(ValueError, match="CUDA"):
        eu.combine_pass(x, w)


@pytest.mark.parametrize("bad", ["indivisible", "dtype", "mixed", "strided",
                                 "block_n"])
def test_wrappers_check_operands(bad):
    a, x, w = torch.zeros(256, 256), torch.zeros(256, 16), torch.zeros(16, 8)
    kw = {"block_n": 128, "block_k": 128}
    if bad == "indivisible":
        a, x = torch.zeros(300, 300), torch.zeros(300, 16)
    elif bad == "dtype":
        a, x, w = a.double(), x.double(), w.double()
    elif bad == "mixed":
        w = w.bfloat16()
    elif bad == "strided":
        x = torch.zeros(16, 256).t()
    else:
        kw["block_n"] = 96
    with pytest.raises(ValueError):
        ops.gnn_aggregate_combine(a, x, w, **kw)
    with pytest.raises(ValueError):
        if bad == "mixed":
            ops.gnn_combine(x, w, block_n=kw["block_n"])
        else:
            ops.gnn_aggregate(a, x, **kw)


def test_cpu_wrappers_count_no_launches():
    ops.reset_launches()
    a, x, w = (torch.ones(s) for s in ((128, 128), (128, 16), (16, 8)))
    ops.gnn_combine(ops.gnn_aggregate(a, x), w)
    ops.gnn_aggregate_combine(a, x, w)
    assert set(ops.LAUNCHES.values()) == {0}


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule under test is the CPU one")
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        params.gcn_combine_weights(params.gcn_params((4, 3, 2)))
    assert backend.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# Inputs and weights carried across.
# ---------------------------------------------------------------------------
_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in
                                    build.SIGNATURES.items() for fn in fns])
def test_ctypes_signature_matches_the_cuda_entry_point(lib, fn):
    """The argument types ctypes passes are those the ``extern "C"`` entry
    point in ``csrc/<lib>.cu`` declares: a pointer as ``void*``, and each
    scalar at its own width."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    decl = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert decl, f"no entry point {fn} in {lib}.cu"
    declared = [ctypes.c_void_p if "*" in arg
                else _C_TYPES[arg.split()[-2]]
                for arg in decl.group(1).split(",")]
    assert declared == build.SIGNATURES[lib][fn]


def test_cora_graph_size_and_normalisation_match_reference():
    g = data.cora_graph(seed=3)
    assert data.CORA_V == 2708 and data.CORA_E == 10556
    assert len(g.senders) == data.CORA_E + data.CORA_V
    loops = g.senders == g.receivers
    assert loops.sum() == data.CORA_V
    fwd = set(zip(g.senders[~loops].tolist(), g.receivers[~loops].tolist()))
    assert len(fwd) == data.CORA_E and fwd == {(r, s) for s, r in fwd}
    batch = GraphBatch(node_feat=jnp.zeros((g.n_nodes, 1)),
                       senders=jnp.asarray(g.senders),
                       receivers=jnp.asarray(g.receivers))
    expect = np.asarray(sym_norm_coeffs(batch))
    np.testing.assert_allclose(g.weights, expect, rtol=1e-6)
    a = g.dense_adjacency()
    assert a.shape == (2816, 2816) and not a[2708:].any()
    assert not a[:, 2708:].any()
    np.testing.assert_allclose(a, a.T)
    x = data.cora_features(seed=3)
    assert x.shape == (2816, 1433) and not x[2708:].any()
    assert set(np.unique(x)) <= {0.0, 1.0}


def test_gcn_combine_weights_give_the_reference_layer_outputs():
    cfg = make_smoke_config()
    p = jgcn.init_params(cfg, jax.random.PRNGKey(0))
    p_np = jax.tree_util.tree_map(np.asarray, p)
    ws = params.gcn_combine_weights(p_np, device="cpu")
    assert [tuple(w.shape) for w in ws] == [(24, 8), (8, 3)]
    n = 128
    g = data.cora_graph(seed=1, n_nodes=100, n_edges=300)
    a = g.dense_adjacency(n)
    x = data.cora_features(seed=1, n_nodes=100, n_pad=n, width=cfg.d_in)
    j_h, h = jnp.asarray(x), torch.as_tensor(x)
    for i, (jw, w) in enumerate(zip(p["w"], ws)):
        j_h = jops.gnn_aggregate_combine(jnp.asarray(a), j_h, jw,
                                         block_n=128, block_k=128)
        h = ops.gnn_aggregate_combine(torch.as_tensor(a), h, w, block_n=128,
                                      block_k=128)
        assert _rel(h.numpy(), np.asarray(j_h)) < 1e-5
        if i < len(ws) - 1:
            j_h, h = jax.nn.relu(j_h), torch.relu(h)


def test_gcn_combine_weights_refuse_a_bias_and_broken_widths():
    p = params.gcn_params((6, 4, 2))
    p["b"][1] = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="bias"):
        params.gcn_combine_weights(p, device="cpu")
    p = params.gcn_params((6, 4, 2))
    p["w"][1] = np.zeros((5, 2), np.float32)
    with pytest.raises(ValueError, match="chain"):
        params.gcn_combine_weights(p, device="cpu")


# ---------------------------------------------------------------------------
# The f32 kernels' arithmetic: 3xTF32, emulated on the CPU.
# ---------------------------------------------------------------------------
def _tf32_rna(v: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round to 10 stored significand bits, ties away
    from zero (the 13 dropped bits are rounded on the magnitude)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_aggregate(a: np.ndarray, x: np.ndarray, block_k: int,
                    terms: int) -> np.ndarray:
    """A @ X as K1 and K2 form it: each operand split into hi = rna(v) and
    lo = rna(v - hi); per source block the sum of hi.hi (+ lo.hi + hi.lo
    with terms=3) taken exactly (products of TF32 values are exact in fp32,
    summed in float64 here), and the source blocks added in fp32."""
    a_hi, x_hi = _tf32_rna(a), _tf32_rna(x)
    a_lo, x_lo = _tf32_rna(a - a_hi), _tf32_rna(x - x_hi)
    acc = np.zeros((a.shape[0], x.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], block_k):
        ks = slice(k0, k0 + block_k)
        part = a_hi[:, ks].astype(np.float64) @ x_hi[ks].astype(np.float64)
        if terms == 3:
            part += (a_hi[:, ks].astype(np.float64) @ x_lo[ks].astype(np.float64)
                     + a_lo[:, ks].astype(np.float64) @ x_hi[ks].astype(np.float64))
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


@pytest.fixture(scope="module")
def cora_layers():
    """The seeded Cora inputs of both GCN layers, f32: (A, X, W) each."""
    n = 2816   # V padded, as at both Cora operating points (Bk = 256)
    g = data.cora_graph(seed=0)
    a = g.dense_adjacency(n).astype(np.float32)
    x = data.cora_features(seed=0, n_pad=n).astype(np.float32)
    w1, w2 = (w.numpy() for w in params.gcn_combine_weights(
        params.gcn_params(data.CORA_WIDTHS, seed=0), device="cpu"))
    h1 = np.maximum(_tf32_aggregate(a, x, 256, 3) @ w1, 0).astype(np.float32)
    return {"cora_layer1": (a, x, w1), "cora_layer2": (a, h1, w2)}


@pytest.mark.parametrize("layer", ["cora_layer1", "cora_layer2"])
def test_three_tf32_products_hold_f32_where_one_misses(layer, cora_layers):
    """K1's and K2's f32 arithmetic (3xTF32) holds the f32 gate of 1e-5
    against the plain versions and the JAX reference on the seeded Cora
    inputs of each layer; one TF32 product misses it."""
    a, x, w = cora_layers[layer]
    ta, tx, tw = (torch.as_tensor(v) for v in (a, x, w))
    plain_agg = eu.aggregate_pass_plain(ta, tx).numpy()
    plain_out = ea.fused_aggregate_combine_plain(ta, tx, tw).numpy()
    ref_out = np.asarray(jref.fused_aggregate_combine_ref(
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(w)))
    three = _tf32_aggregate(a, x, 256, 3)
    one = _tf32_aggregate(a, x, 256, 1)
    tol = DTYPES["f32"][2]
    assert _rel(three, plain_agg) < tol / 10
    assert _rel(three @ w, plain_out) < tol / 10
    assert _rel(three @ w, ref_out) < tol / 10
    assert _rel(one, plain_agg) > tol
    assert _rel(one @ w, plain_out) > tol


def test_tf32_rounding_is_round_to_nearest_away():
    v = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 3.0 * 2.0 ** -12], np.float32)
    got = _tf32_rna(v)
    assert list(got) == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 3.0 * 2.0 ** -12]
    # hi + lo carries 22 of the value's 24 significand bits.
    v = np.float32([np.pi, 1 / 3, 1e-3 * np.e])
    hi = _tf32_rna(v)
    two = hi.astype(np.float64) + _tf32_rna(v - hi)
    assert np.all(np.abs(two - v) <= 2.0 ** -21 * np.abs(v))
    assert np.all(np.abs(hi - v) > 2.0 ** -21 * np.abs(v))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n,f,t,bn,bk", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernels_match_plain_versions(n, f, t, bn, bk, dtype,
                                           cuda_device):
    _, (a, x, w), tol = _both(_layer_inputs(n, f, t, n), dtype)
    a, x, w = (v.to(cuda_device) for v in (a, x, w))
    out = ea.fused_aggregate_combine(a, x, w, block_n=bn, block_k=bk)
    assert _rel(_np(out.cpu()), _np(ea.fused_aggregate_combine_plain(
        a, x, w).cpu())) < tol
    agg = eu.aggregate_pass(a, x, block_n=bn, block_k=bk)
    assert _rel(_np(agg.cpu()), _np(eu.aggregate_pass_plain(a, x).cpu())) < tol
    out2 = eu.combine_pass(agg, w, block_n=bn)
    assert _rel(_np(out2.cpu()), _np(eu.combine_pass_plain(agg, w).cpu())) < tol
    torch.cuda.synchronize()


#: (n, f, t, block_n, block_k): one feature chunk whose 16 source blocks
#: split over 4 ranks, and 6 feature chunks over a cluster of 6 (in bf16 X's
#: 1400-byte rows start off 16-byte boundaries).
CLUSTER_SHAPES = [(2048, 24, 5, 64, 128), (1024, 700, 9, 64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,t,bn,bk", CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_cluster_schedules_match_plain_versions(n, f, t, bn, bk, dtype,
                                                     cuda_device):
    sched = ea.fused_grid_spec(n, f, t, bn, bk)
    assert sched.grid[0] in (4, 6)
    _, (a, x, w), tol = _both(_layer_inputs(n, f, t, n + f), dtype)
    a, x, w = (v.to(cuda_device) for v in (a, x, w))
    out = ea.fused_aggregate_combine(a, x, w, block_n=bn, block_k=bk)
    agg = eu.aggregate_pass(a, x, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    assert _rel(_np(out.cpu()), _np(ea.fused_aggregate_combine_plain(
        a, x, w).cpu())) < tol
    assert _rel(_np(agg.cpu()), _np(eu.aggregate_pass_plain(a, x).cpu())) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,t,bn", [(2816, 1433, 16, 32), (2816, 16, 7, 64),
                                      (1024, 700, 9, 64), (512, 2000, 33, 32),
                                      (256, 32, 8, 128), (512, 300, 3, 512)])
def test_cuda_combine_ranks_match_the_plan(n, f, t, bn, cuda_device):
    """The C side's ranks per destination block are combine_grid_spec's, and
    the combine on those ranks matches its plain version."""
    sched = eu.combine_grid_spec(n, f, t, bn)
    lib = build.library("edge_aggregate_unfused")
    assert lib.combine_ranks(n, f, t, bn, sched.chunk) == sched.grid[0]
    assert lib.combine_active_clusters(n, f, t, bn, sched.chunk, 0) >= 1
    _, (y, w), tol = _both(_layer_inputs(n, f, t, n + t)[1:], "f32")
    y, w = y.to(cuda_device), w.to(cuda_device)
    out = eu.combine_pass(y, w, block_n=bn)
    assert _rel(_np(out.cpu()), _np(eu.combine_pass_plain(y, w).cpu())) < tol


@pytest.mark.gpu
def test_cuda_wrappers_count_their_launches(cuda_device):
    ops.reset_launches()
    a, x, w = (torch.ones(s, device=cuda_device)
               for s in ((256, 256), (256, 16), (16, 8)))
    ops.gnn_aggregate_combine(a, x, w)
    ops.gnn_combine(ops.gnn_aggregate(a, x), w)
    torch.cuda.synchronize()
    layer = ("edge_aggregate", "edge_aggregate_unfused.aggregate",
             "edge_aggregate_unfused.combine")
    assert [ops.LAUNCHES[k] for k in layer] == [1, 1, 1]
    assert sum(ops.LAUNCHES.values()) == 3
