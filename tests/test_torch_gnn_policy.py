"""GNN training under a sharding policy, held to the reference's own policy
steps.

The battery: GCN (also with the ``"graphs"`` readout on a batch of small
graphs), GatedGCN, MeshGraphNet and EquiformerV2 at their smoke configs
(EquiformerV2 also with 4 edge chunks, its Wigner blocks whole or
pre-chunked), on the (2, 4) and (4, 2) meshes, three steps of the reference's
``_gnn_plan`` train step (``module.loss_fn(cfg, q, g, policy=)`` then
``adamw(1e-3)``, jitted with the batch laid out by ``_gnn_graph_specs``)
on 8 fake CPU devices (``tests/torch_policy_train_ref.py``) against three
steps of the port's ``launch.steps.gnn_train_cell(policy=)`` on 8 gloo
ranks (``tests/torch_policy_train_checks.py``), from the reference's
``init_params`` on a seeded power-law graph whose node and edge counts are
multiples of 8: every loss within 1e-4, and per leaf the step-3
parameters (over the entries whose first gradient passes 1e-3 of the
leaf's largest) and moments within 1e-4.  A leaf whose first gradient is
under 2^-23 of the model's largest is zero but for rounding in both
packages and is skipped by name: EquiformerV2's ``layers/attn_mlp/b[1]``
(a bias shared by a head's scores does not move their softmax), and no
other.  The reference's own policy steps stay within 2.3e-05 of its
single-device step on these leaves, a margin of 4x to the tolerance.

Every rank's collective ledger of the first step equals the paper's SpMM
traffic model to the byte (``launch.steps.gnn_policy_traffic``): the
``gnn_gather`` all-gathers, and their backward's reduce-scatters, are
``spmm_feature_allgather(N_pad, width, node ranks)`` summed over the
gathered tensors (GCN ``d_hidden`` then ``n_classes`` wide, GatedGCN and
MeshGraphNet ``d_hidden`` a layer, EquiformerV2 ``L2 * C / tp`` and
``C`` a layer, its channels over the ``model`` ranks, the last two over
the dp ranks); the three models that recompute their layers in the
backward pass gather each layer's table again, the same bytes under
``gnn_gather_remat``; EquiformerV2's sums over ``model`` are ``gnn_tp``
and ``gnn_tp_remat``; and ``grad_dp`` is
``dp_gradient_sync(param_bytes, n_devices)``.  No other collective but
the readout's scalar psums (``gnn_readout``) runs.

At world size 1 (one gloo rank) the policy cell runs the single-device
step's products: against the single-device cell on the batch the shard
trains on (the nodes padded to 512), losses within 1e-6 and the step-3
parameters within 1e-5.

The rank views and the layers run in-process: over hypothesis-drawn
graphs and 1, 2, 4 and 8 ranks, every unmasked edge lies on one rank,
its receiver's, in ``partition_edges_gather``'s layout (a masked edge on
none); and with the gather
faked (every rank's rows known), the ranks' outputs of one layer of each
model gathered back give the single-device layer within 1e-6.
"""

from __future__ import annotations

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch as ref_get_arch
from repro.data import synthetic as ref_synthetic
from repro.launch import steps as ref_steps
from repro_torch import params as P
from repro_torch.configs import get_arch
from repro_torch.core import comm_model
from repro_torch.data.wigner import rotation_to_z, wigner_stack
from repro_torch.distributed.ring import partition_edges_gather
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.gnn.graph import GraphBatch, shard_graph
from repro_torch.tree import tree_paths
from test_torch_policy_train import PORT, _finish, _run_both, _start

NAMES = ("gcn-cora", "gatedgcn", "meshgraphnet", "equiformer-v2")
MESHES = ((2, 4), (4, 2))
#: (model, variant): GCN also reads out per graph, on a batch of graphs;
#: EquiformerV2 also convolves its edges in EDGE_CHUNKS chunks, with its
#: Wigner blocks whole (the shard pads a rank's edges to a multiple of the
#: chunks) or pre-chunked (the shard flattens, cuts and chunks them again).
MODELS = [(name, "nodes") for name in NAMES] + [
    ("gcn-cora", "graphs"), ("equiformer-v2", "chunked"),
    ("equiformer-v2", "pre_chunked")]
EDGE_CHUNKS = 4
CASES = [(name, shape, readout) for name, readout in MODELS
         for shape in MESHES]
STEPS = 3
N_NODES, N_EDGES = 64, 256
TOL = 1e-4
#: World size 1 against one device: the losses, and the step-3
#: parameters.  The gathered senders' table is a tensor of its own, so a
#: node's gradient adds its parts in another order than on one device:
#: GatedGCN's ``layers/ln_e_b`` reads 1.7e-06 after three steps.
WORLD1_TOL, WORLD1_PARAM_TOL = 1e-6, 1e-5
LAYER_TOL = 1e-6
#: Parameters are held where the first gradient passes this share of the
#: leaf's largest (AdamW moves an unresolved entry by the full rate).
GRAD_ROUNDING_SHARE = 1e-3
#: A leaf whose first gradient is under this share of the model's largest
#: (and not exactly zero) is zero but for rounding, in both packages: held
#: at no entry.
GRAD_ZERO_SHARE = 2.0 ** -23
#: The only leaves below GRAD_ZERO_SHARE.
ZERO_LEAVES = {"equiformer-v2": {"layers/attn_mlp/b/1"}}


def _ids(case) -> str:
    name, shape, readout = case
    return f"{name}-{readout}-{shape[0]}x{shape[1]}"


def _cfg_kw(name: str, readout: str) -> dict:
    if readout == "graphs":
        return {"readout": "graphs"}
    if readout in ("chunked", "pre_chunked"):
        return {"edge_chunks": EDGE_CHUNKS}
    return {}


def _batch(name: str, readout: str, cfg) -> dict:
    """A seeded numpy batch in the reference's layout: a power-law graph
    of 64 nodes (or 8 graphs of 8 nodes for the graph readout), node and
    edge counts multiples of 8."""
    rng = np.random.default_rng(1)
    n_classes = getattr(cfg, "n_classes", 3)
    if readout == "graphs":
        gid = np.repeat(np.arange(8), 8)
        base = gid * 8
        snd = base[rng.integers(0, 64, 256)] + rng.integers(0, 8, 256)
        rcv = (snd // 8) * 8 + rng.integers(0, 8, 256)
        snd = np.concatenate([snd, np.arange(64)])
        rcv = np.concatenate([rcv, np.arange(64)])
        return dict(
            node_feat=rng.standard_normal((64, cfg.d_in)).astype(np.float32),
            senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
            labels=rng.integers(0, n_classes, 8).astype(np.int32),
            graph_ids=gid.astype(np.int32), n_graphs=8)
    eq = name == "equiformer-v2"
    ga = ref_synthetic.power_law_graph(0, n_nodes=N_NODES, n_edges=N_EDGES,
                                       d_feat=cfg.d_in, n_classes=n_classes,
                                       self_loops=not eq)
    kw = dict(node_feat=ga.node_feat, senders=ga.senders,
              receivers=ga.receivers, labels=ga.labels)
    e = ga.senders.shape[0]
    if name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = rng.standard_normal(
            (e, cfg.d_edge_in)).astype(np.float32)
    if name == "meshgraphnet":
        kw["labels"] = rng.standard_normal(
            (N_NODES, cfg.d_out)).astype(np.float32)
    if eq:
        pos = rng.standard_normal((N_NODES, 3))
        vecs = pos[ga.senders] - pos[ga.receivers]
        kw["wigner"] = {l: w.astype(np.float32) for l, w in wigner_stack(
            np.stack([rotation_to_z(v) for v in vecs]), cfg.l_max,
            m_max=cfg.m_max).items()}
        kw["positions"] = pos.astype(np.float32)
        kw["labels"] = rng.standard_normal((1, cfg.d_out)).astype(np.float32)
        if readout == "pre_chunked":
            kw["wigner"] = {l: w.reshape(EDGE_CHUNKS, -1, *w.shape[1:])
                            for l, w in kw["wigner"].items()}
    return kw


def _data() -> dict:
    params, batch, cfg_kw = {}, {}, {}
    for name, readout in MODELS:
        kw = _cfg_kw(name, readout)
        cfg = ref_get_arch(name).make_smoke_config(**kw)
        module = ref_steps._GNN_MODULES[name]
        params[(name, readout)] = jax.tree_util.tree_map(
            np.asarray, module.init_params(cfg, jax.random.key(0)))
        batch[(name, readout)] = _batch(name, readout, cfg)
        cfg_kw[(name, readout)] = kw
    return {"params": params, "batch": batch, "cfg_kw": cfg_kw,
            "steps": STEPS}


@pytest.fixture(scope="module")
def gnn_runs(tmp_path_factory):
    data = {**_data(), "cases": CASES}
    splits = [[c for c in CASES if c[1] == shape] for shape in MESHES]
    return _run_both(tmp_path_factory.mktemp("gnn"), "gnn", data, splits)


def _key(path) -> str:
    return "/".join(map(str, path))


def _hold(got: dict, want: dict, tol: float) -> list[str]:
    """Per leaf, ``got``'s parameters (over the entries ``want``'s first
    gradient resolves) and moments against ``want``'s within ``tol`` of
    the leaf's largest; returns the skipped leaves' paths."""
    mus = tree_paths(want["first_mu"])
    top = max(float(np.max(np.abs(m))) for _, m in mus)
    skipped = []
    for key in ("params", "mu", "nu"):
        wl, gl = tree_paths(want[key]), dict(tree_paths(got[key]))
        assert [p for p, _ in wl] == [p for p, _ in mus]
        for (path, w), (_, m) in zip(wl, mus):
            g = np.asarray(gl[path], np.float64)
            w = np.asarray(w, np.float64)
            assert g.shape == w.shape, (key, path, g.shape, w.shape)
            leaf = float(np.max(np.abs(m)))
            if 0.0 < leaf < GRAD_ZERO_SHARE * top:
                if key == "params":
                    skipped.append(_key(path))
                continue
            diff = np.abs(g - w)
            if key == "params":
                diff = diff[np.abs(m) > GRAD_ROUNDING_SHARE * leaf]
            err = float(np.max(diff, initial=0.0)) / (
                float(np.max(np.abs(w))) + 1e-12)
            assert err < tol, (key, _key(path), err)
    return skipped


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gnn_policy_step_matches_reference(gnn_runs, case):
    ref, port = gnn_runs
    want, got = ref[case], port[case]
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(g - w) / abs(w) < TOL, (i, g, w)
    skipped = _hold(got, want, TOL)
    print(f"{_ids(case)}: leaves skipped (zero to rounding) {skipped}")
    assert set(skipped) == ZERO_LEAVES.get(case[0], set())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gnn_policy_ledger_equals_the_traffic_models(gnn_runs, case):
    _, port = gnn_runs
    name, shape, readout = case
    res = port[case]
    cfg = get_arch(name).make_smoke_config(**_cfg_kw(name, readout))
    policy = make_policy(AbstractMesh(("data", "model"), shape))
    _, n = steps.gnn_node_split(name, policy)
    n_total = res["n_total"]
    assert n_total == steps._pad(N_NODES)
    (n_loc, _), = {tuple(s) for s in res["sizes"]}
    assert n_loc * n == n_total
    param_bytes = sum(4 * np.size(a) for _, a in tree_paths(res["params"]))
    model = steps.gnn_policy_traffic(name, cfg, policy, n_total, param_bytes)
    gather = model[("gnn_gather", "all-gather")]
    assert res["rank_ledgers"][0] == res["ledger"]
    assert len(res["rank_ledgers"]) == 8
    for rank, ledger in enumerate(res["rank_ledgers"]):
        by = {}
        for kind, tag, _, _, wire in ledger:
            by[(tag, kind)] = by.get((tag, kind), 0.0) + wire
        # Each gather alone, the forward's and the recompute's, is the SpMM
        # model at the width it moved.
        for kind, tag, result, size, wire in ledger:
            if kind == "all-gather" and tag in ("gnn_gather",
                                                "gnn_gather_remat"):
                width = result / (4 * n_total)
                assert size == n and width == int(width)
                assert wire == comm_model.spmm_feature_allgather(
                    n_total, int(width), n).total("ici")
        remat = by.get(("gnn_gather_remat", "all-gather"), 0.0)
        assert remat == (gather if name in steps.GNN_REMAT else 0.0), rank
        for key, b in model.items():
            assert by[key] == b, (rank, key, by[key], b)
        assert set(by) <= set(model) | {("gnn_readout", "all-reduce")}
    print(f"{_ids(case)}: every rank's gnn_gather {gather} B, "
          f"gnn_gather_remat {remat} B, grad_dp "
          f"{by[('grad_dp', 'all-reduce')]} B, gnn_readout "
          f"{by.get(('gnn_readout', 'all-reduce'), 0.0)} B")


@pytest.fixture(scope="module")
def world1_runs(tmp_path_factory):
    data = {**_data(), "cases": [(name, (1, 1), readout)
                                 for name, readout in MODELS]}
    tmp = tmp_path_factory.mktemp("gnn1")
    path = tmp / "gnn1.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return _finish(_start(PORT, "gnn1", path, tmp / "out.pkl"),
                   tmp / "out.pkl")


@pytest.mark.parametrize("model", MODELS, ids=lambda m: f"{m[0]}-{m[1]}")
def test_world1_policy_step_equals_single_device(world1_runs, model):
    """One gloo rank: the policy cell (every collective over one rank, the
    ledger 0 B) against the single-device cell from the same weights on
    the shard's padded batch, three steps."""
    got = world1_runs[(model[0], (1, 1), model[1])]
    pol, one = got["policy"], got["single"]
    for a, b in zip(pol["losses"], one["losses"]):
        assert abs(a - b) / abs(b) < WORLD1_TOL, (a, b)
    assert sum(op[4] for op in pol["ledger"]) == 0.0
    mus = dict(tree_paths(pol["first_mu"]))
    top = max(float(np.max(np.abs(m))) for m in mus.values())
    worst = (-1.0, "")
    got_params = dict(tree_paths(pol["params"]))
    for path, w in tree_paths(one["params"]):
        m = mus[path]
        leaf = float(np.max(np.abs(m)))
        if 0.0 < leaf < GRAD_ZERO_SHARE * top:
            continue
        diff = np.abs(got_params[path] - w)[
            np.abs(m) > GRAD_ROUNDING_SHARE * leaf]
        err = float(np.max(diff, initial=0.0)) / (np.max(np.abs(w)) + 1e-12)
        worst = max(worst, (err, _key(path)))
    print(f"{model}: world-1 step-3 parameters, worst leaf {worst}")
    assert worst[0] < WORLD1_PARAM_TOL, worst


@pytest.mark.parametrize("shape", MESHES + ((1, 1),))
@pytest.mark.parametrize("model", MODELS, ids=lambda m: f"{m[0]}-{m[1]}")
def test_graph_specs_equal_reference(model, shape):
    """``steps.gnn_graph_specs`` is the reference's ``_gnn_graph_specs``,
    field for field (a spec tuple for a ``PartitionSpec``)."""
    from types import SimpleNamespace

    name, readout = model
    cfg = ref_get_arch(name).make_smoke_config(**_cfg_kw(name, readout))
    batch = _batch(name, readout, cfg)
    policy = make_policy(AbstractMesh(("data", "model"), shape))
    ref_policy = SimpleNamespace(dp_spec=policy.dp_spec,
                                 dp_axes=policy.dp_axes,
                                 tp_axis=policy.tp_axis)
    g = GraphBatch(**batch)
    want = ref_steps._gnn_graph_specs(ref_get_arch(name), g, ref_policy,
                                      None)
    got = steps.gnn_graph_specs(name, g, policy)
    for f in dataclasses.fields(GraphBatch):
        w, v = getattr(want, f.name), getattr(got, f.name)
        if f.name == "wigner" and w is not None:
            assert {l: tuple(x) for l, x in w.items()} == v
        elif f.name == "n_graphs" or w is None:
            assert w == v, f.name
        else:
            assert tuple(w) == v, f.name


# ---------------------------------------------------------------------------
# The rank views and the layers, in-process
# ---------------------------------------------------------------------------

class _OneRank:
    """The policy calls of ``shard_graph`` for rank ``r`` of ``n`` node
    ranks, with no process group: a fake gather stands in for the
    collectives."""

    def __init__(self, n: int, r: int):
        self.n, self.r, self.n_devices = n, r, n

    def size(self, axes) -> int:
        return self.n

    def coord(self, axes) -> int:
        return self.r

    def group(self, axes):
        return None


def _views(name: str, g: GraphBatch, n: int) -> list:
    specs = steps.gnn_graph_specs(
        name, g, make_policy(AbstractMesh(("data", "model"), (n, 1))))
    n_total = steps._pad(g.n_nodes)
    return [shard_graph(g, specs, _OneRank(n, r), n_total=n_total)
            for r in range(n)]


@settings(max_examples=40, deadline=None)
@given(n_nodes=st.integers(1, 700), n_edges=st.integers(0, 300),
       ranks=st.sampled_from([1, 2, 4, 8]), seed=st.integers(0, 2**16))
def test_rank_views_cover_every_edge_once(n_nodes, n_edges, ranks, seed):
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n_nodes, n_edges)
    rcv = rng.integers(0, n_nodes, n_edges)
    emask = (rng.random(n_edges) < 0.9).astype(np.float32)
    g = GraphBatch(node_feat=rng.standard_normal((n_nodes, 3)).astype(
        np.float32), senders=snd, receivers=rcv, edge_mask=emask,
        labels=rng.integers(0, 3, n_nodes)).to("cpu")
    views = _views("gcn-cora", g, ranks)
    n_total = views[0].n_total
    n_loc = n_total // ranks
    keep = emask > 0
    part = partition_edges_gather(snd[keep], rcv[keep], emask[keep],
                                  n_total, ranks)
    seen = np.zeros(n_edges, np.int64)
    for r, v in enumerate(views):
        assert v.n_nodes == n_loc
        np.testing.assert_array_equal(v.senders.numpy(), part.senders[r])
        np.testing.assert_array_equal(v.receivers.numpy(),
                                      part.receivers[r])
        np.testing.assert_array_equal(v.edge_mask.numpy(), part.weights[r])
        ids = v.edge_ids.numpy()
        real = ids[ids >= 0]
        assert np.all(rcv[real] // n_loc == r)
        np.testing.assert_array_equal(v.receivers.numpy()[ids >= 0],
                                      rcv[real] - r * n_loc)
        np.testing.assert_array_equal(v.senders.numpy()[ids >= 0], snd[real])
        assert not v.edge_mask.numpy()[ids < 0].any()
        np.add.at(seen, real, 1)
        lo = r * n_loc
        nm = v.node_mask.numpy()
        assert nm.sum() == max(0, min(n_loc, n_nodes - lo))
    np.testing.assert_array_equal(seen, keep.astype(np.int64))


def _layer_graph(name: str, cfg) -> GraphBatch:
    rng = np.random.default_rng(7)
    n, e = 90, 400
    snd = rng.integers(0, n, e)
    rcv = (snd + 1 + rng.integers(0, n - 1, e)) % n
    kw = dict(node_feat=rng.standard_normal((n, cfg.d_in)).astype(
        np.float32), senders=snd, receivers=rcv,
        edge_mask=(rng.random(e) < 0.9).astype(np.float32))
    if name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = rng.standard_normal(
            (e, cfg.d_edge_in)).astype(np.float32)
    if name == "equiformer-v2":
        pos = rng.standard_normal((n, 3))
        kw["wigner"] = wigner_stack(np.stack(
            [rotation_to_z(v) for v in pos[snd] - pos[rcv]]), cfg.l_max,
            m_max=cfg.m_max)
    kw["labels"] = np.zeros(n, np.int32)
    return GraphBatch(**kw).to("cpu")


def _pad_nodes(g: GraphBatch, n_total: int) -> GraphBatch:
    """``g`` with masked zero nodes up to ``n_total`` (the single-device
    layer on the shards' padded node set)."""
    pad = n_total - g.n_nodes
    return dataclasses.replace(
        g, node_feat=torch.cat([g.node_feat, g.node_feat.new_zeros(
            (pad, g.node_feat.shape[1]))]),
        node_mask=torch.cat([g.nmask(), g.nmask().new_zeros(pad)]),
        labels=torch.cat([g.labels, g.labels.new_zeros(pad)]))


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-12)
    assert err < LAYER_TOL, err


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_layer_equals_single_device(name, ranks):
    """One layer of each model on every rank's view, the senders' table
    faked from the whole input, the ranks' node rows concatenated and
    their unmasked edges put back in place: the single-device layer on the
    padded graph."""
    cfg = get_arch(name).make_smoke_config()
    if name == "gcn-cora":
        cfg = dataclasses.replace(cfg, n_layers=1)
    torch.manual_seed(0)
    g = _layer_graph(name, cfg)
    views = _views(name, g, ranks)
    full = _pad_nodes(g, views[0].n_total)
    tree = P.gnn_params(cfg, seed=3)
    d = cfg.d_hidden
    with torch.no_grad():
        if name == "gcn-cora":
            model = P.load_gcn(tree, cfg, device="cpu")
            want = model(full)
            table = full.node_feat @ model.w[0] + model.b[0]
            outs = []
            for v in views:
                v.senders_table = lambda x: table
                outs.append(model(v))
            _close(torch.cat(outs), want)
            return
        if name == "equiformer-v2":
            model = P.load_equiformer_v2(tree, cfg, device="cpu")
            lp = model.layers[0]
            x = torch.randn(full.n_nodes, cfg.L2, d)
            # The layer gathers two tables (the normed rows and the
            # attention's senders' half): each rank gets the whole graph's.
            tables = []
            full.senders_table = lambda x_: tables.append(x_) or x_
            want = model._layer(lp, x, full, full.emask())
            assert len(tables) == 2
            outs = []
            for r, v in enumerate(views):
                v.senders_table = lambda x_, t=iter(tables): next(t)
                n_loc = v.n_nodes
                outs.append(model._layer(lp, x[r * n_loc:(r + 1) * n_loc],
                                         v, v.emask()))
            _close(torch.cat(outs), want)
            return
        h = torch.randn(full.n_nodes, d)
        e = torch.randn(g.n_edges, d)
        if name == "gatedgcn":
            layer = P.load_gatedgcn(tree, cfg, device="cpu").layers[0]
        else:
            layer = P.load_meshgraphnet(tree, cfg, device="cpu").processors[0]
        want_h, want_e = layer(h, e, full, full.emask()[:, None])
        hs, es = [], []
        for r, v in enumerate(views):
            v.senders_table = lambda x_: h
            n_loc = v.n_nodes
            ids = v.edge_ids
            e_loc = torch.where((ids >= 0)[:, None], e[ids.clamp_min(0)],
                                torch.zeros(()))
            h_r, e_r = layer(h[r * n_loc:(r + 1) * n_loc], e_loc, v,
                             v.emask()[:, None])
            hs.append(h_r)
            es.append((ids, e_r))
        _close(torch.cat(hs), want_h)
        got_e = torch.zeros_like(want_e)
        for ids, e_r in es:
            got_e[ids[ids >= 0]] = e_r[ids >= 0]
        real = g.emask() > 0  # a masked edge lies on no rank
        _close(got_e[real], want_e[real])
