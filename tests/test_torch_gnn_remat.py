"""Activation checkpointing in the port's GNNs, held to the reference's.

The reference's GatedGCN, MeshGraphNet and EquiformerV2 take ``remat=True``
by default and wrap each layer in ``jax.checkpoint(..., policy=
nothing_saveable)``; EquiformerV2 also wraps each edge chunk's convolution
and scatter.  The port's models do the same with
``models.common.checkpoint_layer``.  For the three models (EquiformerV2
with whole, chunked and pre-chunked Wigner blocks), at smoke sizes on the
CPU:

* through ``params.tree_loss`` (the tree bound by ``functional_call``, as
  the train step binds it), the loss and every gradient with remat are bit
  for bit those without, and the forward outputs too, while the module's
  own weights are another draw than the tree's.  A recompute that read the
  module's own weights would miss: a plain ``torch.utils.checkpoint`` of
  the same layers does, which the test shows;
* the remat gradients against the reference's ``jax.value_and_grad`` of
  its ``loss_fn`` within ``GRAD_TOL`` (each relative to the larger of the
  leaf's largest and 1% of the model's largest gradient), the outputs
  within ``OUT_TOL``;
* the recompute runs: each layer's body twice with remat and once
  without, and with chunks each chunk's convolution three times (the
  forward, the layer's recompute, the chunk's recompute).

The dry run's counters see the recompute: ``launch.counters.FlopCounter``
counts ``FlopCounterMode``'s FLOPs without its module hooks, which hold
each layer's recompute alive, so the traced remat peak is the step's.

And ``graph.shard_graph`` on pre-chunked Wigner blocks: equal to
flattening them, sharding the whole blocks and chunking each rank's edges
again; every real edge on one rank, its receiver's; a rank's edges a
multiple of the chunks, its pad edges masked; one EquiformerV2 layer on
the ranks' views (the senders' gather faked) equal to the single-device
layer on the padded graph within 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graph as jgraph
from repro.models.gnn import meshgraphnet as jmgn
from repro_torch import params as P
from repro_torch.data.wigner import rotation_to_z, wigner_stack
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn import gatedgcn, meshgraphnet
from repro_torch.models.gnn.graph import GraphBatch, shard_graph
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from test_torch_gnn_policy import _close, _OneRank, _pad_nodes

CASES = ("gatedgcn", "meshgraphnet", "equiformer-v2",
         "equiformer-v2-chunked", "equiformer-v2-pre_chunked")
#: Outputs, and losses and gradients, as ``tests/test_torch_gnn_models.py``
#: holds the models to the reference.
OUT_TOL, GRAD_TOL, GRAD_SCALE_SHARE = 1e-5, 1e-4, 1e-2
#: Edge chunks of the chunked cases.
CHUNKS = 4
CPU = torch.device("cpu")


def _graph(case: str, rng) -> tuple:
    """(reference module, config, port module, loader, numpy batch) of a
    case: a graph of 16 nodes and 48 edges (no self-loops), the last 8
    edges and 2 nodes masked padding."""
    n, e = 16, 48
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = ((snd + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
    kw = dict(senders=snd, receivers=rcv,
              node_mask=np.r_[np.ones(n - 2), np.zeros(2)].astype(np.float32),
              edge_mask=np.r_[np.ones(e - 8), np.zeros(8)].astype(np.float32))
    if case == "gatedgcn":
        cfg = gatedgcn.GatedGCNConfig(n_layers=3, d_in=6, d_edge_in=4,
                                      d_hidden=12, n_classes=3)
        kw["labels"] = rng.integers(0, 3, n).astype(np.int32)
        mods = (jgatedgcn, gatedgcn, P.load_gatedgcn)
    elif case == "meshgraphnet":
        cfg = meshgraphnet.MeshGraphNetConfig(n_layers=3, d_in=6, d_edge_in=4,
                                              d_hidden=16)
        kw["labels"] = rng.standard_normal((n, 3)).astype(np.float32)
        mods = (jmgn, meshgraphnet, P.load_meshgraphnet)
    else:
        cfg = eqv2.EquiformerV2Config(
            n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4, d_in=6,
            edge_chunks=CHUNKS if case.endswith("-chunked") else 1)
        kw["labels"] = rng.standard_normal((1, 1)).astype(np.float32)
        pos = rng.standard_normal((n, 3))
        kw["positions"] = pos.astype(np.float32)
        wig = wigner_stack(np.stack([rotation_to_z(v) for v in
                                     pos[snd] - pos[rcv]]),
                           cfg.l_max, m_max=cfg.m_max)
        if case.endswith("pre_chunked"):
            wig = {l: w.reshape(CHUNKS, -1, *w.shape[1:])
                   for l, w in wig.items()}
        kw["wigner"] = wig
        mods = (jeqv2, eqv2, P.load_equiformer_v2)
    kw["node_feat"] = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    if case in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = rng.standard_normal(
            (e, cfg.d_edge_in)).astype(np.float32)
    jmod, module, load = mods
    return jmod, cfg, module, load, kw


class _NoRemat:
    """``model`` as the loss functions call it (``model(g)``, its
    ``cfg``), each call with ``remat=False``."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def __call__(self, g):
        return self.model(g, remat=False)


def _setup(case: str, seed: int = 0) -> dict:
    """The reference's weights (its ``init_params`` at key 3) as a tree of
    tensors, a module holding another draw (key 4), the batch on the CPU
    for both packages, and the reference's forward, loss and gradients."""
    rng = np.random.default_rng(seed)
    jmod, cfg, module, load, kw = _graph(case, rng)
    jp = jax.tree_util.tree_map(np.asarray,
                                jmod.init_params(cfg, jax.random.key(3)))
    other = jax.tree_util.tree_map(np.asarray,
                                   jmod.init_params(cfg, jax.random.key(4)))
    model = load(other, cfg, device=CPU)
    jg = jgraph.GraphBatch(**{
        k: ({l: jnp.asarray(w) for l, w in v.items()} if k == "wigner"
            else jnp.asarray(v)) for k, v in kw.items()})
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda q: jmod.loss_fn(cfg, q, jg), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, jp))
    return {"cfg": cfg, "module": module, "model": model, "jp": jp,
            "g": GraphBatch(**kw).to(CPU),
            "j_out": np.asarray(jmod.forward(cfg, jp, jg)),
            "j_loss": float(j_loss),
            "j_grads": jax.tree_util.tree_map(np.asarray, j_grads)}


def _loss_and_grads(s: dict, remat: bool) -> tuple:
    """The loss and the tree's gradients through ``tree_loss``."""
    module, model = s["module"], s["model"]
    fn = module.loss_fn if remat else (
        lambda m, g: module.loss_fn(_NoRemat(m), g))
    tree = tree_map(lambda a: torch.tensor(a, requires_grad=True), s["jp"])
    loss, _ = P.tree_loss(model, fn)(tree, s["g"])
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    return loss.detach(), grads


def _outputs(s: dict, remat: bool) -> torch.Tensor:
    """The forward's outputs through ``tree_loss``, grad enabled."""
    tree = tree_map(lambda a: torch.tensor(a, requires_grad=True), s["jp"])
    return P.tree_loss(s["model"], lambda m, g: m(g, remat=remat))(
        tree, s["g"]).detach()


@pytest.fixture(scope="module", params=CASES)
def setup(request):
    return request.param, _setup(request.param)


def test_remat_equals_no_remat_through_tree_loss(setup):
    """Bit for bit: the loss, every gradient and the outputs."""
    case, s = setup
    loss, grads = _loss_and_grads(s, remat=True)
    loss_off, grads_off = _loss_and_grads(s, remat=False)
    assert torch.equal(loss, loss_off), (loss, loss_off)
    for (path, _), a, b in zip(tree_paths(s["jp"]), grads, grads_off):
        assert torch.equal(a, b), (case, path, float((a - b).abs().max()))
    out, out_off = _outputs(s, True), _outputs(s, False)
    assert torch.equal(out, out_off)
    with torch.no_grad():
        assert torch.equal(s["model"](s["g"]), s["model"](s["g"],
                                                          remat=False))


def test_remat_gradients_equal_reference(setup):
    """The remat step's loss and gradients against the reference's
    ``jax.value_and_grad`` (its ``loss_fn`` remats too); the outputs."""
    case, s = setup
    out = _outputs(s, True).numpy()
    want = s["j_out"]
    assert np.max(np.abs(out - want)) / np.max(np.abs(want)) < OUT_TOL
    loss, grads = _loss_and_grads(s, remat=True)
    assert abs(float(loss) - s["j_loss"]) / abs(s["j_loss"]) < GRAD_TOL
    want = jax.tree_util.tree_leaves(s["j_grads"])
    top = max(float(np.max(np.abs(w))) for w in want)
    for (path, _), g, w in zip(tree_paths(s["jp"]), grads, want):
        scale = max(float(np.max(np.abs(w))), GRAD_SCALE_SHARE * top)
        err = float(np.max(np.abs(g.numpy() - w))) / scale
        assert err < GRAD_TOL, (case, path, err)


def test_plain_checkpoint_reads_the_module_weights(setup, monkeypatch):
    """The trap ``checkpoint_layer`` closes: a plain non-reentrant
    ``torch.utils.checkpoint`` of the same layers recomputes them after
    ``tree_loss``'s ``functional_call`` has returned, through the module's
    own weights (another draw here), and its gradients miss the tree's
    with no error."""
    case, s = setup

    def plain(module, *args, fn=None, enabled=True):
        call = fn or torch.nn.Module.__call__
        if not enabled:
            return call(module, *args)
        return checkpoint(lambda *a: call(module, *a), *args,
                          use_reentrant=False)

    monkeypatch.setattr(s["module"], "checkpoint_layer", plain)
    loss, grads = _loss_and_grads(s, remat=True)
    monkeypatch.undo()
    loss_off, grads_off = _loss_and_grads(s, remat=False)
    assert torch.equal(loss, loss_off)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads, grads_off))
    assert worst > 1e-2, (case, worst)


def test_remat_recomputes_each_layer_and_chunk(setup, monkeypatch):
    """With remat each layer's body runs twice (the forward, then its
    recompute in the backward pass), once without; with chunks each
    chunk's convolution runs three times with remat and twice without (the
    layer's recompute runs each chunk's forward again, and its backward
    each chunk's recompute)."""
    case, s = setup
    if case.startswith("equiformer"):
        target, name = eqv2, "_so2_conv"
    elif case == "gatedgcn":
        target, name = gatedgcn.GatedGCNLayer, "forward"
    else:
        target, name = meshgraphnet.Processor, "forward"
    calls = []
    real = getattr(target, name)

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(target, name, counted)
    counts = {}
    for remat in (True, False):
        calls.clear()
        _loss_and_grads(s, remat=remat)
        counts[remat] = len(calls)
    layers = s["cfg"].n_layers
    chunks = CHUNKS if case != "equiformer-v2" and case.startswith(
        "equiformer") else 1
    if chunks == 1:
        assert counts == {True: 2 * layers, False: layers}, counts
    else:
        assert counts == {True: 3 * layers * chunks,
                          False: 2 * layers * chunks}, counts


# ---------------------------------------------------------------------------
# Pre-chunked Wigner blocks under a policy
# ---------------------------------------------------------------------------

def _chunked_graph(n: int = 70, e: int = 240, chunks: int = 6,
                   seed: int = 5):
    """A seeded EquiformerV2 batch of ``n`` nodes and ``e`` edges (a tenth
    masked), its Wigner blocks pre-chunked into ``chunks``."""
    cfg = dataclasses.replace(
        eqv2.EquiformerV2Config(n_layers=1, d_hidden=8, l_max=2, m_max=1,
                                n_heads=2, d_in=3), edge_chunks=chunks)
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, e)
    rcv = (snd + 1 + rng.integers(0, n - 1, e)) % n
    pos = rng.standard_normal((n, 3))
    wig = wigner_stack(np.stack([rotation_to_z(v) for v in
                                 pos[snd] - pos[rcv]]), cfg.l_max,
                       m_max=cfg.m_max)
    kw = dict(node_feat=rng.standard_normal((n, cfg.d_in)).astype(
        np.float32), senders=snd, receivers=rcv,
        edge_mask=(rng.random(e) < 0.9).astype(np.float32),
        labels=np.zeros((1, 1), np.float32),
        positions=pos.astype(np.float32),
        wigner={l: w.reshape(chunks, -1, *w.shape[1:]).astype(np.float32)
                for l, w in wig.items()})
    return cfg, GraphBatch(**kw).to(CPU)


def _rank_views(g: GraphBatch, ranks: int, **kw) -> list:
    specs = steps.gnn_graph_specs(
        "equiformer-v2", g,
        make_policy(AbstractMesh(("data", "model"), (ranks, 1))))
    return [shard_graph(g, specs, _OneRank(ranks, r),
                        n_total=steps._pad(g.n_nodes), **kw)
            for r in range(ranks)]


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_pre_chunked_shard_equals_flatten_shard_rechunk(ranks):
    cfg, g = _chunked_graph()
    chunks = cfg.edge_chunks
    flat = dataclasses.replace(g, wigner={
        l: w.reshape(-1, *w.shape[2:]) for l, w in g.wigner.items()})
    got = _rank_views(g, ranks)
    want = _rank_views(flat, ranks, edge_chunks=chunks)
    emask = g.emask().numpy()
    seen = np.zeros(g.n_edges, np.int64)
    for r, (a, b) in enumerate(zip(got, want)):
        e_loc = a.n_edges
        assert e_loc % chunks == 0 and e_loc == b.n_edges
        for f in ("senders", "receivers", "edge_mask", "edge_ids",
                  "node_feat", "node_mask"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (r, f)
        ids = a.edge_ids
        real = ids >= 0
        for l, w in a.wigner.items():
            assert w.shape == (chunks, e_loc // chunks, *w.shape[2:])
            assert torch.equal(w.reshape(b.wigner[l].shape), b.wigner[l])
            flat_l = w.reshape(e_loc, *w.shape[2:])
            assert torch.equal(flat_l[real], flat.wigner[l][ids[real]])
            assert not flat_l[~real].any()
        assert not a.edge_mask[~real].any()
        n_loc = a.n_nodes
        assert torch.all(g.receivers[ids[real]] // n_loc == r)
        np.add.at(seen, ids[real].numpy(), 1)
    np.testing.assert_array_equal(seen, (emask > 0).astype(np.int64))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_pre_chunked_sharded_layer_equals_single_device(ranks):
    """One EquiformerV2 layer on every rank's view of pre-chunked blocks
    (the senders' table faked from the whole input), the ranks' node rows
    concatenated: the single-device layer on the padded graph."""
    cfg, g = _chunked_graph()
    views = _rank_views(g, ranks)
    full = _pad_nodes(dataclasses.replace(
        g, labels=torch.zeros(g.n_nodes)), views[0].n_total)
    model = P.load_equiformer_v2(P.gnn_params(cfg, seed=3), cfg, device=CPU)
    lp = model.layers[0]
    torch.manual_seed(0)
    x = torch.randn(full.n_nodes, cfg.L2, cfg.d_hidden)
    with torch.no_grad():
        # The layer gathers two tables (the normed rows and the attention's
        # senders' half): each rank gets the whole graph's.
        tables = []
        full.senders_table = lambda x_: tables.append(x_) or x_
        want = model._layer(lp, x, full, full.emask())
        assert len(tables) == 2
        outs = []
        for r, v in enumerate(views):
            v.senders_table = lambda x_, t=iter(tables): next(t)
            n_loc = v.n_nodes
            outs.append(model._layer(lp, x[r * n_loc:(r + 1) * n_loc], v,
                                     v.emask()))
    _close(torch.cat(outs), want)


def test_dry_run_counters_see_the_recompute_free():
    """The dry run's counters around a remat step (MeshGraphNet, real
    tensors): ``counters.FlopCounter`` counts what ``FlopCounterMode``
    counts, and under it the peak is the remat peak, below the step's
    without remat; ``FlopCounterMode``'s module hooks hold each layer's
    recompute until it exits, and its peak is higher."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.counters import FlopCounter, StepCounter

    s = _setup("meshgraphnet")

    def peak_and_flops(remat: bool, flops) -> tuple:
        module = s["module"]
        fn = module.loss_fn if remat else (
            lambda m, g: module.loss_fn(_NoRemat(m), g))
        tree = tree_map(lambda a: torch.tensor(a, requires_grad=True),
                        s["jp"])
        counter = StepCounter()
        counter.hold((tree, s["g"]))
        counter.reset_peak()
        base = counter.live
        with counter, flops:
            loss, _ = P.tree_loss(s["model"], fn)(tree, s["g"])
            torch.autograd.grad(loss, tree_leaves(tree))
            del loss
        total = (flops.total if isinstance(flops, FlopCounter)
                 else flops.get_total_flops())
        return counter.peak - base, total

    remat, remat_flops = peak_and_flops(True, FlopCounter())
    plain, plain_flops = peak_and_flops(False, FlopCounter())
    tracked, tracked_flops = peak_and_flops(True, FlopCounterMode(
        display=False))
    assert remat_flops == tracked_flops > plain_flops > 0
    assert remat < plain, (remat, plain)
    assert tracked > remat, (tracked, remat)
