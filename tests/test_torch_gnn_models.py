"""The port's GNN models held to the reference (the twin of
``tests/test_gnn_models.py``).

The reference's tests are twinned one for one on the port (shapes and
gradients, padding invariance, GatedGCN and MeshGraphNet, EquiformerV2's
rotation invariance, the Wigner representation property, the isolated SO(2)
equivariance).  Parity: the reference's ``init_params`` output, as numpy,
is carried into the port's module by ``repro_torch.params``; the same numpy
graph goes through both; forward outputs must agree to 1e-5 and the loss
and every parameter's gradient (``torch.autograd`` of the plain ops against
``jax.grad``) to 1e-4, relative to the largest magnitude of each array, in
f32 on the CPU (each gradient also relative to at least 1% of the model's
largest).  The Wigner blocks must equal the reference's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import wigner as jwigner
from repro.models import common as jcommon
from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graph as jgraph
from repro.models.gnn import layers as jlayers
from repro.models.gnn import meshgraphnet as jmgn
from repro_torch import params
from repro_torch.data.wigner import (random_rotation, rotation_to_z,
                                     wigner_d_real, wigner_stack)
from repro_torch.models import common
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn import gatedgcn, gcn, graph, layers, meshgraphnet
from repro_torch.models.gnn.graph import GraphBatch

RNG = np.random.default_rng(0)
#: Forward outputs, and losses and gradients: relative to the largest
#: magnitude of the reference's array (with a floor for all-zero arrays).
OUT_TOL, GRAD_TOL, FLOOR = 1e-5, 1e-4, 1e-7
#: A gradient that is zero in exact arithmetic (the attention scores' last
#: bias under the per-segment softmax, which is shift-invariant) is rounding
#: noise in both packages: each gradient is held relative to the larger of
#: its own largest magnitude and this share of the model's largest gradient.
GRAD_SCALE_SHARE = 1e-2
CPU = torch.device("cpu")


def _rel(got, expect) -> float:
    got = np.asarray(got, np.float64)
    expect = np.asarray(expect, np.float64)
    assert got.shape == expect.shape, (got.shape, expect.shape)
    return float(np.max(np.abs(got - expect), initial=0.0)
                 / max(np.max(np.abs(expect), initial=0.0), FLOOR))


def _arrays(n=20, e=60, d=8, n_classes=3, edge_d=None, self_loops=True,
            rng=RNG):
    snd = rng.integers(0, n, e).astype(np.int32)
    if self_loops:
        rcv = rng.integers(0, n, e).astype(np.int32)
    else:
        rcv = ((snd + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
    kw = dict(node_feat=rng.standard_normal((n, d)).astype(np.float32),
              senders=snd, receivers=rcv,
              labels=rng.integers(0, n_classes, n).astype(np.int32))
    if edge_d:
        kw["edge_feat"] = rng.standard_normal((e, edge_d)).astype(np.float32)
    return kw


def _padded(kw, n_pad, e_pad, rng=RNG):
    """``kw`` padded with masked nodes and edges (the padding edges point
    at padding nodes, as the reference test's do)."""
    n, e = kw["node_feat"].shape[0], kw["senders"].shape[0]
    out = dict(kw)
    out["node_feat"] = np.concatenate(
        [kw["node_feat"], np.full((n_pad - n, kw["node_feat"].shape[1]), 9.0,
                                  np.float32)])
    out["senders"] = np.concatenate([kw["senders"], np.full(
        e_pad - e, n_pad - 1, np.int32)])
    out["receivers"] = np.concatenate([kw["receivers"], np.full(
        e_pad - e, n_pad - 2, np.int32)])
    if kw["labels"].shape[0] == n:
        out["labels"] = np.concatenate(
            [kw["labels"], np.zeros((n_pad - n,) + kw["labels"].shape[1:],
                                    kw["labels"].dtype)])
    if "edge_feat" in kw:
        out["edge_feat"] = np.concatenate([kw["edge_feat"], rng.standard_normal(
            (e_pad - e, kw["edge_feat"].shape[1])).astype(np.float32)])
    out["node_mask"] = np.concatenate([np.ones(n, np.float32),
                                       np.zeros(n_pad - n, np.float32)])
    out["edge_mask"] = np.concatenate([np.ones(e, np.float32),
                                       np.zeros(e_pad - e, np.float32)])
    return out


def _molecules(n_graphs=4, n=7, e=12, d=5, n_classes=3, rng=RNG):
    """``n_graphs`` small graphs concatenated, with ``graph_ids``."""
    off = np.repeat(np.arange(n_graphs) * n, e)
    snd = rng.integers(0, n, n_graphs * e)
    rcv = (snd + 1 + rng.integers(0, n - 1, n_graphs * e)) % n
    return dict(node_feat=rng.standard_normal((n_graphs * n, d)).astype(
                    np.float32),
                senders=(snd + off).astype(np.int32),
                receivers=(rcv + off).astype(np.int32),
                graph_ids=np.repeat(np.arange(n_graphs), n).astype(np.int32),
                labels=rng.integers(0, n_classes, n_graphs).astype(np.int32),
                n_graphs=n_graphs)


def _both(kw):
    """The same numpy graph as the reference's batch and the port's."""
    j = jgraph.GraphBatch(**{k: (v if k == "n_graphs" else
                                 {l: jnp.asarray(w) for l, w in v.items()}
                                 if k == "wigner" else jnp.asarray(v))
                             for k, v in kw.items()})
    return j, GraphBatch(**kw).to(CPU)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The port's modules as reference-layout pytrees of values or gradients.
# ---------------------------------------------------------------------------
def _leaf(p, grad):
    t = p.grad if grad else p.detach()
    return np.zeros(tuple(p.shape), np.float32) if t is None else t.numpy()


def _mlp_tree(mlp, grad):
    out = {"w": [_leaf(w, grad) for w in mlp.w],
           "b": [_leaf(b, grad) for b in mlp.b]}
    if hasattr(mlp, "ln_scale"):
        out["ln_scale"] = _leaf(mlp.ln_scale, grad)
        out["ln_bias"] = _leaf(mlp.ln_bias, grad)
    return out


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _port_tree(model, grad=False):
    if isinstance(model, gcn.GCN):
        return {"w": [_leaf(w, grad) for w in model.w],
                "b": [_leaf(b, grad) for b in model.b]}
    if isinstance(model, gatedgcn.GatedGCN):
        return {"embed_h": _leaf(model.embed_h, grad),
                "embed_e": _leaf(model.embed_e, grad),
                "out": _leaf(model.out, grad),
                "layers": _stack([{k: _leaf(getattr(layer, k), grad)
                                   for k in gatedgcn.LAYER_KEYS}
                                  for layer in model.layers])}
    if isinstance(model, meshgraphnet.MeshGraphNet):
        return {"node_enc": _mlp_tree(model.node_enc, grad),
                "edge_enc": _mlp_tree(model.edge_enc, grad),
                "decoder": _mlp_tree(model.decoder, grad),
                "processors": _stack([
                    {"edge_mlp": _mlp_tree(p.edge_mlp, grad),
                     "node_mlp": _mlp_tree(p.node_mlp, grad)}
                    for p in model.processors])}
    cfg = model.cfg

    def layer_tree(layer):
        t = {k: _leaf(getattr(layer, k), grad)
             for k in ["w_m0", "gate", "norm_scale"] + [
                 f"w_m{m}_{s}" for m in range(1, cfg.m_max + 1)
                 for s in ("r", "i")]}
        t["attn_mlp"] = _mlp_tree(layer.attn_mlp, grad)
        t["ffn"] = _mlp_tree(layer.ffn, grad)
        return t

    return {"embed": _leaf(model.embed, grad),
            "out_mlp": _mlp_tree(model.out_mlp, grad),
            "layers": _stack([layer_tree(layer) for layer in model.layers])}


def _same_trees(got, expect, tol, label, *, scale_share=0.0):
    """Leaf by leaf, relative to the larger of the leaf's own largest
    magnitude and ``scale_share`` of the largest magnitude in the tree."""
    g_leaves, g_def = jax.tree_util.tree_flatten_with_path(got)
    e_leaves, e_def = jax.tree_util.tree_flatten_with_path(expect)
    assert g_def == e_def, label
    floor = scale_share * max(float(np.max(np.abs(e))) for _, e in e_leaves)
    for (path, g), (_, e) in zip(g_leaves, e_leaves):
        err = (float(np.max(np.abs(np.asarray(g, np.float64) - e)))
               / max(float(np.max(np.abs(e))), floor, FLOOR))
        assert err < tol, f"{label} {jax.tree_util.keystr(path)}: {err}"


# ---------------------------------------------------------------------------
# Twins of tests/test_gnn_models.py.
# ---------------------------------------------------------------------------
def test_gcn_shapes_and_grads():
    cfg = gcn.GCNConfig(d_in=8, d_hidden=16, n_classes=3)
    _, g = _both(_arrays())
    model = params.load_gcn(params.gnn_params(cfg, seed=0), cfg, device=CPU)
    loss, m = gcn.loss_fn(model, g)
    assert torch.isfinite(loss) and 0 <= float(m["acc"]) <= 1
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_gcn_padding_invariance():
    """Padded (masked) nodes and edges must not change real-node logits."""
    cfg = gcn.GCNConfig(d_in=8, d_hidden=16, n_classes=3)
    kw = _arrays(n=16, e=40)
    model = params.load_gcn(params.gnn_params(cfg, seed=0), cfg, device=CPU)
    with torch.no_grad():
        base = model(GraphBatch(**kw).to(CPU))
        out = model(GraphBatch(**_padded(kw, 24, 56)).to(CPU))
    err = float((out[:16] - base).abs().max())
    assert err < 1e-5, err


def test_gatedgcn_and_meshgraphnet():
    kw = _arrays(edge_d=4)
    cfg = gatedgcn.GatedGCNConfig(n_layers=3, d_in=8, d_edge_in=4,
                                  d_hidden=12, n_classes=3)
    model = params.load_gatedgcn(params.gnn_params(cfg, seed=1), cfg,
                                 device=CPU)
    loss, _ = gatedgcn.loss_fn(model, GraphBatch(**kw).to(CPU))
    assert torch.isfinite(loss)

    kw2 = dict(kw, labels=RNG.standard_normal((20, 3)).astype(np.float32))
    cfg2 = meshgraphnet.MeshGraphNetConfig(n_layers=3, d_in=8, d_hidden=16)
    model2 = params.load_meshgraphnet(params.gnn_params(cfg2, seed=2), cfg2,
                                      device=CPU)
    loss2, _ = meshgraphnet.loss_fn(model2, GraphBatch(**kw2).to(CPU))
    assert torch.isfinite(loss2)
    loss2.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model2.parameters())


def _eqv2_arrays(cfg, pos, feats, snd, rcv):
    vecs = pos[snd] - pos[rcv]
    Rs = np.stack([rotation_to_z(v) for v in vecs])
    return dict(node_feat=feats, senders=snd, receivers=rcv,
                labels=np.ones((1, 1), np.float32),
                wigner=wigner_stack(Rs, cfg.l_max, m_max=cfg.m_max))


def test_equiformer_rotation_invariance():
    n, e = 16, 48
    snd = RNG.integers(0, n, e).astype(np.int32)
    rcv = ((snd + 1 + RNG.integers(0, n - 1, e)) % n).astype(np.int32)
    feats = RNG.standard_normal((n, 4)).astype(np.float32)
    pos = RNG.standard_normal((n, 3))
    cfg = eqv2.EquiformerV2Config(n_layers=3, d_hidden=16, l_max=3, m_max=2,
                                  n_heads=4, d_in=4)
    model = params.load_equiformer_v2(params.gnn_params(cfg, seed=3), cfg,
                                      device=CPU)
    R = random_rotation(RNG)
    with torch.no_grad():
        e1 = model(GraphBatch(**_eqv2_arrays(cfg, pos, feats, snd,
                                             rcv)).to(CPU))
        e2 = model(GraphBatch(**_eqv2_arrays(cfg, pos @ R.T, feats, snd,
                                             rcv)).to(CPU))
    err = float((e1 - e2).abs().max() / (e1.abs().max() + 1e-9))
    assert err < 1e-4, err


def test_wigner_matrices_are_representation():
    rng = np.random.default_rng(1)
    for _ in range(3):
        R1, R2 = random_rotation(rng), random_rotation(rng)
        D1 = wigner_d_real(R1, 6)
        D2 = wigner_d_real(R2, 6)
        D12 = wigner_d_real(R1 @ R2, 6)
        for l in range(7):
            assert np.max(np.abs(D1[l] @ D1[l].T - np.eye(2 * l + 1))) < 1e-9
            assert np.max(np.abs(D1[l] @ D2[l] - D12[l])) < 1e-9
        for a, b in zip(D1, jwigner.wigner_d_real(R1, 6)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_so2_conv_equivariance_isolated():
    cfg = eqv2.EquiformerV2Config(n_layers=1, d_hidden=8, l_max=3, m_max=2,
                                  n_heads=2, d_in=4)
    model = params.load_equiformer_v2(params.gnn_params(cfg, seed=0), cfg,
                                      device=CPU)
    lp = model.layers[0]
    v = RNG.standard_normal(3)
    x = RNG.standard_normal((1, cfg.L2, cfg.d_hidden)).astype(np.float32)

    def conv(vec, feats):
        wig = wigner_stack(rotation_to_z(vec)[None], cfg.l_max,
                           m_max=cfg.m_max)
        with torch.no_grad():
            return eqv2._so2_conv(
                cfg, lp, {l: torch.from_numpy(w) for l, w in wig.items()},
                torch.from_numpy(np.ascontiguousarray(feats))).numpy()

    Rg = random_rotation(RNG)
    Dg = np.zeros((cfg.L2, cfg.L2))
    off = 0
    for D in wigner_d_real(Rg, cfg.l_max):
        n = D.shape[0]
        Dg[off:off + n, off:off + n] = D
        off += n
    out1 = conv(v, x)
    out2 = conv(Rg @ v, np.einsum("pq,eqc->epc", Dg, x).astype(np.float32))
    pred = np.einsum("pq,eqc->epc", Dg, out1)
    assert np.max(np.abs(out2 - pred)) / (np.max(np.abs(pred)) + 1e-9) < 1e-5


# ---------------------------------------------------------------------------
# Parity with the reference: carried-across parameters.
# ---------------------------------------------------------------------------
def _parity(jmod, cfg, load, kw, seed, **fwd_kw):
    """Forward, loss and gradients of the reference and of the port on the
    same numpy graph and the reference's parameters."""
    jp = jmod.init_params(cfg, jax.random.key(seed))
    model = load(_to_np(jp), cfg, device=CPU)
    _same_trees(_port_tree(model), _to_np(jp), 1e-30, "carried weights")
    jg, g = _both(kw)
    expect = np.asarray(jmod.forward(cfg, jp, jg, **fwd_kw))
    got = model(g, **fwd_kw).detach().numpy()
    assert _rel(got, expect) < OUT_TOL, _rel(got, expect)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda q: jmod.loss_fn(cfg, q, jg), has_aux=True)(jp)
    loss, _ = {jgcn: gcn.loss_fn, jgatedgcn: gatedgcn.loss_fn,
               jmgn: meshgraphnet.loss_fn, jeqv2: eqv2.loss_fn}[jmod](model, g)
    assert _rel(float(loss.detach()), float(j_loss)) < GRAD_TOL
    loss.backward()
    _same_trees(_port_tree(model, grad=True), _to_np(j_grads), GRAD_TOL,
                "gradient", scale_share=GRAD_SCALE_SHARE)
    return got


@pytest.mark.parametrize("case", ["nodes", "padded", "graphs"])
def test_gcn_parity(case):
    rng = np.random.default_rng(10)
    if case == "graphs":
        kw = _molecules(rng=rng)
        cfg = gcn.GCNConfig(d_in=5, d_hidden=16, n_classes=3,
                            readout="graphs")
    else:
        kw = _arrays(n=30, e=90, d=12, rng=rng)
        if case == "padded":
            kw = _padded(kw, 36, 100, rng=rng)
        cfg = gcn.GCNConfig(n_layers=3, d_in=12, d_hidden=16, n_classes=3)
    _parity(jgcn, cfg, params.load_gcn, kw, seed=4)


def test_gcn_agg_dtype_and_aggregate_hook():
    """``agg_dtype`` (bf16) and an ``aggregate_fn`` with the reference's
    signature run as in the reference."""
    rng = np.random.default_rng(11)
    kw = _arrays(n=30, e=90, d=12, rng=rng)
    cfg = gcn.GCNConfig(d_in=12, d_hidden=16, n_classes=3)
    jp = jgcn.init_params(cfg, jax.random.key(5))
    model = params.load_gcn(_to_np(jp), cfg, device=CPU)
    jg, g = _both(kw)
    with torch.no_grad():
        got = model(g, agg_dtype=torch.bfloat16)
    expect = np.asarray(jgcn.forward(cfg, jp, jg, agg_dtype=jnp.bfloat16))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), expect) < 3e-2
    calls = []

    def hook(h, snd, rcv, n, *, edge_weight=None):
        calls.append(tuple(h.shape))
        return layers.gather_scatter_sum(h, snd, rcv, n,
                                         edge_weight=edge_weight)

    with torch.no_grad():
        np.testing.assert_array_equal(model(g, aggregate_fn=hook).numpy(),
                                      model(g).numpy())
    assert calls == [(30, 16), (30, 3)]


@pytest.mark.parametrize("case", ["nodes", "padded", "graphs"])
def test_gatedgcn_parity(case):
    rng = np.random.default_rng(12)
    if case == "graphs":
        kw = _molecules(rng=rng)
        kw["edge_feat"] = rng.standard_normal(
            (kw["senders"].size, 4)).astype(np.float32)
        cfg = gatedgcn.GatedGCNConfig(n_layers=3, d_in=5, d_edge_in=4,
                                      d_hidden=12, n_classes=3,
                                      readout="graphs")
    else:
        kw = _arrays(n=24, e=70, d=8, edge_d=4, rng=rng)
        if case == "padded":
            kw = _padded(kw, 30, 80, rng=rng)
        cfg = gatedgcn.GatedGCNConfig(n_layers=3, d_in=8, d_edge_in=4,
                                      d_hidden=12, n_classes=3)
    _parity(jgatedgcn, cfg, params.load_gatedgcn, kw, seed=6)


@pytest.mark.parametrize("case", ["edge_feat", "padded", "no_edge_feat"])
def test_meshgraphnet_parity(case):
    rng = np.random.default_rng(13)
    kw = _arrays(n=24, e=70, d=8, edge_d=None if case == "no_edge_feat"
                 else 4, rng=rng)
    kw["labels"] = rng.standard_normal((24, 3)).astype(np.float32)
    if case == "padded":
        kw = _padded(kw, 30, 80, rng=rng)
    cfg = meshgraphnet.MeshGraphNetConfig(n_layers=3, d_in=8, d_edge_in=4,
                                          d_hidden=16)
    _parity(jmgn, cfg, params.load_meshgraphnet, kw, seed=7)


@pytest.mark.parametrize("case", ["one_graph", "molecules", "chunked",
                                  "pre_chunked", "padded"])
def test_equiformer_parity(case):
    rng = np.random.default_rng(14)
    cfg = eqv2.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2,
                                  n_heads=4, d_in=4,
                                  edge_chunks=4 if case == "chunked" else 1)
    if case == "molecules":
        kw = _molecules(n_graphs=3, n=8, e=16, d=4, rng=rng)
        kw["labels"] = rng.standard_normal((3, 1)).astype(np.float32)
    else:
        n, e = 14, 40
        snd = rng.integers(0, n, e).astype(np.int32)
        rcv = ((snd + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
        kw = dict(node_feat=rng.standard_normal((n, 4)).astype(np.float32),
                  senders=snd, receivers=rcv,
                  labels=rng.standard_normal((1, 1)).astype(np.float32))
    pos = rng.standard_normal((kw["node_feat"].shape[0], 3))
    if case == "padded":
        kw = _padded(kw, 18, 48, rng=rng)
        pos = np.concatenate([pos, rng.standard_normal((4, 3))])
    vecs = pos[kw["senders"]] - pos[kw["receivers"]]
    kw["wigner"] = wigner_stack(np.stack([rotation_to_z(v) for v in vecs]),
                                cfg.l_max, m_max=cfg.m_max)
    kw["positions"] = pos.astype(np.float32)
    if case == "pre_chunked":
        kw["wigner"] = {l: w.reshape(5, -1, *w.shape[1:])
                        for l, w in kw["wigner"].items()}
    _parity(jeqv2, cfg, params.load_equiformer_v2, kw, seed=8)


# ---------------------------------------------------------------------------
# The primitives and the batch.
# ---------------------------------------------------------------------------
def test_segment_ops_equal_reference_with_empty_segments():
    """Segments with no member: the maximum is 0 and the softmax finite, as
    in the reference; every other value equal to it at 1e-6."""
    rng = np.random.default_rng(15)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ids = rng.integers(0, 6, 40).astype(np.int32) * 2  # odd ids empty
    mask = (rng.random(40) > 0.3).astype(np.float32)
    t_vals, t_ids, t_mask = (torch.from_numpy(vals),
                             torch.from_numpy(ids).long(),
                             torch.from_numpy(mask))
    j_vals, j_ids, j_mask = jnp.asarray(vals), jnp.asarray(ids), \
        jnp.asarray(mask)
    n = 13
    pairs = [
        (common.segment_softmax(t_vals, t_ids, n),
         jcommon.segment_softmax(j_vals, j_ids, n)),
        (layers.scatter_sum(t_vals, t_ids, n, edge_mask=t_mask),
         jlayers.scatter_sum(j_vals, j_ids, n, edge_mask=j_mask)),
        (layers.scatter_mean(t_vals, t_ids, n, edge_mask=t_mask),
         jlayers.scatter_mean(j_vals, j_ids, n, edge_mask=j_mask)),
        (layers.scatter_mean(t_vals, t_ids, n),
         jlayers.scatter_mean(j_vals, j_ids, n)),
        (layers.scatter_max(t_vals, t_ids, n, edge_mask=t_mask),
         jlayers.scatter_max(j_vals, j_ids, n, edge_mask=j_mask)),
        (layers.scatter_max(t_vals, t_ids, n),
         jlayers.scatter_max(j_vals, j_ids, n)),
        (layers.gather_scatter_sum(t_vals, t_ids // 2, t_ids, n,
                                   edge_weight=t_mask),
         jlayers.gather_scatter_sum(j_vals, j_ids // 2, j_ids, n,
                                    edge_weight=j_mask)),
    ]
    for got, expect in pairs:
        assert bool(torch.isfinite(got).all())
        assert _rel(got.numpy(), expect) < 1e-6
    assert float(layers.scatter_max(t_vals, t_ids, n)[1].abs().max()) == 0.0


def test_segment_sums_accumulate_in_float64():
    """Past 2^24 equal terms a float32 sum stops counting (the reference's
    ``segment_sum`` gives 2^24 here); the port's accumulates in float64 a
    chunk at a time and returns float32.  This is the one place the port
    differs from the reference by design."""
    n = (1 << 24) + 4  # a float32 (spacing 2 past 2^24)
    ones = torch.ones(n, 1)
    ids = torch.zeros(n, dtype=torch.long)
    got = common.segment_sum(ones, ids, 2)
    assert got.dtype == torch.float32
    assert got[:, 0].tolist() == [float(n), 0.0]
    assert float(jlayers.scatter_sum(jnp.ones((n, 1)), jnp.zeros(n, jnp.int32),
                                     2)[0, 0]) == float(1 << 24)
    chunked = common.segment_sum(torch.arange(12.0).reshape(6, 2),
                                 torch.tensor([0, 1, 0, 1, 2, 0]), 3)
    np.testing.assert_array_equal(chunked.numpy(), [[14, 17], [8, 10],
                                                    [8, 9]])


def test_degrees_and_sym_norm_equal_reference():
    kw = _padded(_arrays(n=16, e=40, rng=np.random.default_rng(16)), 20, 48)
    jg, g = _both(kw)
    for direction in ("in", "out"):
        np.testing.assert_allclose(
            graph.degrees(g, direction=direction).numpy(),
            np.asarray(jgraph.degrees(jg, direction=direction)), rtol=0)
    assert _rel(graph.sym_norm_coeffs(g).numpy(),
                np.asarray(jgraph.sym_norm_coeffs(jg))) < 1e-6


def test_graph_batch_to_widens_indices_once():
    kw = _molecules()
    kw["wigner"] = {0: np.ones((kw["senders"].size, 1, 1), np.float32)}
    g = GraphBatch(**kw).to("cpu")
    for name in ("senders", "receivers", "graph_ids", "labels"):
        assert getattr(g, name).dtype == torch.int64, name
    assert g.node_feat.dtype == torch.float32
    assert g.wigner[0].dtype == torch.float32
    assert g.n_nodes == 28 and g.n_edges == 48 and g.n_graphs == 4
    assert g.emask().shape == (48,) and g.nmask().shape == (28,)
    assert g.to("cpu").senders.dtype == torch.int64


def test_gnn_params_layout_equals_reference():
    """The seeded numpy draw has the reference ``init_params``'s tree,
    shapes and dtypes, so either loads through the same function."""
    cfgs = [(jgcn, gcn.GCNConfig(d_in=6, d_hidden=8, n_classes=3)),
            (jgatedgcn, gatedgcn.GatedGCNConfig(n_layers=2, d_in=6,
                                                d_edge_in=3, d_hidden=8)),
            (jmgn, meshgraphnet.MeshGraphNetConfig(n_layers=2, d_in=6,
                                                   d_hidden=8)),
            (jeqv2, eqv2.EquiformerV2Config(n_layers=2, d_hidden=8,
                                            l_max=2, m_max=1, n_heads=2))]
    for jmod, cfg in cfgs:
        got = params.gnn_params(cfg, seed=0)
        expect = _to_np(jmod.init_params(cfg, jax.random.key(0)))
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        e_leaves, e_def = jax.tree_util.tree_flatten(expect)
        assert g_def == e_def, cfg.name
        for a, b in zip(g_leaves, e_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype, cfg.name
    with pytest.raises(TypeError, match="GNN config"):
        params.gnn_params(object())


def test_loaders_refuse_mismatched_shapes():
    cfg = gatedgcn.GatedGCNConfig(n_layers=2, d_in=6, d_edge_in=3,
                                  d_hidden=8)
    p = params.gnn_params(cfg, seed=0)
    p["embed_h"] = p["embed_h"][:, :4]
    with pytest.raises(ValueError, match="embed_h"):
        params.load_gatedgcn(p, cfg, device="cpu")
    cfg2 = gcn.GCNConfig(d_in=6, d_hidden=8, n_classes=3)
    p2 = params.gnn_params(cfg2, seed=0)
    p2["w"] = p2["w"][:1]
    with pytest.raises(ValueError, match="layers"):
        params.load_gcn(p2, cfg2, device="cpu")
