"""``repro_torch.launch.steps`` against the reference's ``launch/steps.py``:
the padded sampled-subgraph sizes, the constants and the storage rule,
and one GNN train step on a sampled subgraph (the ``minibatch_lg`` batch
builder at world size 1), card-free: the port on CPU tensors against the
reference's ``_gnn_plan`` train step, within 1e-4."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graph as jgraph
from repro.models.gnn import meshgraphnet as jmgn
from repro.optim.optimizers import adamw as jadamw
from repro.optim.optimizers import apply_updates as japply
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.data import synthetic
from repro_torch.data.sampler import build_csr, sample_subgraph
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as tr

TOL = 1e-4
GRAD_FLOOR = 1e-3
GRAD_ZERO_SHARE = 2.0 ** -23
J_MODULES = {"gcn-cora": jgcn, "gatedgcn": jgatedgcn, "meshgraphnet": jmgn,
             "equiformer-v2": jeqv2}


def test_constants_match_reference():
    assert steps.PAD_TO == ref_steps.PAD_TO
    assert steps.GNN_N_CLASSES == ref_steps.GNN_N_CLASSES
    for n in (0, 1, 511, 512, 513, 10**6):
        assert steps._pad(n) == ref_steps._pad(n)


@pytest.mark.parametrize("shape", sorted(GNN_SHAPES))
def test_sampled_subgraph_sizes_match_reference(shape):
    p = GNN_SHAPES[shape].params
    batch, fanout = p.get("batch_nodes", 1024), tuple(p.get("fanout",
                                                            (15, 10)))
    assert steps.sampled_subgraph_sizes(batch, fanout) == \
        ref_steps.sampled_subgraph_sizes(batch, fanout)


def test_minibatch_lg_sizes():
    p = GNN_SHAPES["minibatch_lg"].params
    assert steps.sampled_subgraph_sizes(
        p["batch_nodes"], tuple(p["fanout"])) == (169_984, 168_960)


@settings(max_examples=50, deadline=None)
@given(batch=st.integers(1, 5000),
       fanout=st.lists(st.integers(1, 30), min_size=0, max_size=4))
def test_sampled_subgraph_sizes_drawn(batch, fanout):
    assert steps.sampled_subgraph_sizes(batch, tuple(fanout)) == \
        ref_steps.sampled_subgraph_sizes(batch, tuple(fanout))


@pytest.mark.parametrize("name,devices", [
    ("gemma2-2b", 1), ("gemma2-2b", 4), ("smollm-135m", 1),
    ("qwen3-moe-30b-a3b", 4), ("arctic-480b", 256), ("granite-3-2b", 1)])
def test_storage_rule_matches_reference(name, devices):
    """bf16 parameters and moments once the f32 triple passes 9e9 bytes a
    device (``_lm_plan``'s rule, from the reference's param count)."""
    ref_cfg = ref_get_arch(name).make_config()
    big = 12.0 * ref_cfg.param_count() / devices > 9e9
    policy = make_policy(AbstractMesh(("data", "model"), (devices, 1)))
    want = torch.bfloat16 if big else torch.float32
    assert steps.lm_train_dtype(get_arch(name).make_config(), policy) == want


def test_opt_state_specs_take_the_parameters_layout():
    policy = make_policy(AbstractMesh(("data", "model"), (2, 4)))
    cfg = get_arch("gemma2-2b").make_config()
    specs = tr.train_pspecs(cfg, policy)
    opt = steps._opt_state_specs(specs)
    assert opt.mu is specs and opt.nu is specs and opt.step == ()
    # FSDP: the embedding's rows over model, its width over data.
    assert specs["embed"] == ("model", "data")


def test_gnn_cell_refuses_a_sharded_policy():
    policy = make_policy(AbstractMesh(("data", "model"), (2, 4)))
    with pytest.raises(ValueError, match="10c"):
        steps.gnn_train_cell("gcn-cora", "minibatch_lg", policy,
                             device="cpu")


def _graph(cfg, arch: str, seed: int = 0):
    n_nodes, n_edges = 400, 3200
    n_classes = getattr(cfg, "n_classes", 3)
    ga = synthetic.power_law_graph(seed, n_nodes=n_nodes, n_edges=n_edges,
                                   d_feat=cfg.d_in, n_classes=n_classes,
                                   self_loops=False)
    rng = np.random.default_rng(seed)
    labels = ga.labels
    positions = None
    if arch == "meshgraphnet":
        labels = rng.standard_normal((n_nodes, cfg.d_out)).astype(np.float32)
    elif arch == "equiformer-v2":
        labels = rng.standard_normal((1, cfg.d_out)).astype(np.float32)
        positions = rng.standard_normal((n_nodes, 3))
    return ga, labels, positions


def _ref_batch(g) -> jgraph.GraphBatch:
    kw = {}
    for f in ("node_feat", "senders", "receivers", "edge_feat", "labels",
              "node_mask", "edge_mask", "positions"):
        v = getattr(g, f)
        if v is not None:
            kw[f] = jnp.asarray(v)
    if g.wigner is not None:
        kw["wigner"] = {l: jnp.asarray(w) for l, w in g.wigner.items()}
    return jgraph.GraphBatch(**kw, n_graphs=g.n_graphs)


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn", "meshgraphnet",
                                  "equiformer-v2"])
def test_sampled_train_step_matches_reference(arch):
    """One train step of ``gnn_train_cell`` at world size 1 on a sampled
    subgraph laid out by ``subgraph_batch`` (padded to
    ``sampled_subgraph_sizes``), from the reference's ``init_params``,
    against the reference's ``_gnn_plan`` step: the loss and the updated
    parameters (where the gradient passes 1e-3 of its leaf's largest, in
    the leaves f32 resolves) within 1e-4."""
    cfg = get_arch(arch).make_smoke_config()
    jcfg = ref_get_arch(arch).make_smoke_config()
    ga, labels, positions = _graph(cfg, arch)
    batch_nodes, fanout = 16, (4, 3)
    n_pad, e_pad = steps.sampled_subgraph_sizes(batch_nodes, fanout)
    csr = build_csr(ga.senders, ga.receivers, ga.n_nodes)
    rng = np.random.default_rng(5)
    seeds = rng.choice(ga.n_nodes, batch_nodes, replace=False)
    sub = sample_subgraph(csr, seeds, fanout, rng=rng, n_pad=n_pad,
                          e_pad=e_pad)
    g = steps.subgraph_batch(arch, cfg, sub, ga.node_feat, labels,
                             positions=positions)
    assert g.node_feat.shape[0] == n_pad and g.senders.shape[0] == e_pad

    jparams = jax.tree_util.tree_map(
        np.asarray, J_MODULES[arch].init_params(jcfg, jax.random.key(0)))
    policy = make_policy(AbstractMesh(("data", "model"), (1, 1)))
    cell = steps.gnn_train_cell(arch, "minibatch_lg", policy, jparams,
                                cfg=cfg, device="cpu")
    params, state, metrics = cell.step(cell.params, cell.opt_state,
                                       g.to("cpu"))

    opt = jadamw(1e-3)
    module = J_MODULES[arch]
    jg = _ref_batch(g)
    (jloss, _), grads = jax.value_and_grad(
        lambda q: module.loss_fn(jcfg, q, jg), has_aux=True)(jparams)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    want = japply(jparams, updates)

    assert abs(float(metrics["loss"]) - float(jloss)) <= TOL * abs(
        float(jloss))
    got_l = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, want))
    grad_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)]
    from repro_torch.tree import tree_leaves
    port_l = [t.detach().numpy() for t in tree_leaves(params)]
    assert len(got_l) == len(port_l) == len(grad_l)
    g_max = max(float(np.max(np.abs(gr))) for gr in grad_l)
    for i, (p, w, gr) in enumerate(zip(port_l, got_l, grad_l)):
        assert p.shape == w.shape, (i, p.shape, w.shape)
        # AdamW moves an entry whose gradient f32 does not resolve by the
        # full rate either way: held where the gradient passes 1e-3 of its
        # leaf's largest.  A leaf under f32's epsilon of the model's
        # largest is zero but for rounding in both packages (EquiformerV2's
        # last attention bias: a bias shared by a head's scores does not
        # move their softmax) and is held at no entry.
        leaf_max = float(np.max(np.abs(gr)))
        if leaf_max < GRAD_ZERO_SHARE * g_max:
            continue
        mask = np.abs(gr) > GRAD_FLOOR * leaf_max
        err = np.max(np.abs(p - w)[mask], initial=0.0) / (
            np.max(np.abs(w)) + 1e-12)
        assert err < TOL, (i, w.shape, err)
