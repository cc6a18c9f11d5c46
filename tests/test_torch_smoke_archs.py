"""Twin of ``tests/test_smoke_archs.py``: every registered architecture's
smoke config runs one train step (and a serve step where it serves) in the
port and in the reference on the CPU, from the reference's weights carried
across, and the losses, logits and scores agree within 1e-4 relative.  The
published configs construct with the reference's parameter counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import all_cells as jall_cells
from repro.configs import get_arch as jget_arch
from repro.data import synthetic as jsynthetic
from repro.data.wigner import rotation_to_z, wigner_stack
from repro.launch import train as jtrain
from repro.models import dlrm as jdlrm
from repro.models import transformer as jtr
from repro.models.gnn.graph import GraphBatch as JGraphBatch
from repro.optim.optimizers import adamw as jadamw
from repro.optim.optimizers import apply_updates as japply
from repro_torch import params
from repro_torch.configs import REGISTRY, all_cells, get_arch
from repro_torch.launch.steps import gnn_train_cell
from repro_torch.models import dlrm
from repro_torch.models import transformer as tr
from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.optim.optimizers import adamw, make_step
from repro_torch.tree import tree_leaves

LM_ARCHS = [a for a, d in REGISTRY.items() if d.family == "lm"]
GNN_ARCHS = [a for a, d in REGISTRY.items() if d.family == "gnn"]
TOL = 1e-4


def _np_tree(jtree):
    return jax.tree_util.tree_map(np.asarray, jtree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    return float(np.abs(got - want).max(initial=0.0)) / scale


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all())
               for t in tree_leaves(tree) if torch.is_tensor(t))


def test_registry_covers_assignment():
    assert len(REGISTRY) == 10
    cells = all_cells(include_skipped=True)
    assert len(cells) == 40                       # 10 archs x 4 shapes
    skipped = [c for c in cells if c[2].startswith("SKIP")]
    assert len(skipped) == 4                      # 4 pure-full-attn long_500k
    assert all(c[1] == "long_500k" for c in skipped)
    assert cells == jall_cells(include_skipped=True)
    assert list(REGISTRY) == list(JREGISTRY)


@pytest.mark.parametrize("arch_name", LM_ARCHS)
def test_lm_smoke_train_and_decode(arch_name):
    jcfg = jget_arch(arch_name).make_smoke_config()
    cfg = get_arch(arch_name).make_smoke_config()
    jparams = jtr.init_params(jcfg, jax.random.key(0))
    B, S = 2, 16
    batch = jsynthetic.lm_batch(0, 0, batch=B, seq=S, vocab=jcfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = jadamw(1e-3)
    _, _, jm = jax.jit(jtr.make_train_step(jcfg, jopt))(
        jparams, jopt.init(jparams), jbatch)
    tree = params.tensor_tree(_np_tree(jparams), device="cpu")
    opt = adamw(1e-3)
    p2, _, m = tr.make_train_step(cfg, opt)(
        tree, opt.init(tree), {k: torch.from_numpy(np.array(v))
                               for k, v in batch.items()})
    assert _rel(float(m["loss"]), float(jm["loss"])) < TOL, arch_name
    assert _finite(p2)
    # One decode step at position 0 from the same weights.
    jcache = jtr.init_cache(jcfg, B, S)
    jlogits, _ = jax.jit(jtr.make_serve_step(jcfg, S))(
        jparams, jcache, jbatch["tokens"][:, :1], jnp.asarray(0, jnp.int32))
    model = params.load_transformer(_np_tree(jparams), cfg, device="cpu",
                                    dtype=torch.float32)
    logits, _ = tr.make_serve_step(cfg, S)(
        model, tr.init_cache(cfg, B, S, device="cpu"),
        torch.from_numpy(np.array(batch["tokens"][:, :1])), 0)
    assert logits.shape == (B, cfg.vocab)
    assert _rel(logits, jlogits) < TOL, arch_name


def _gnn_arrays(arch_name, cfg):
    rng = np.random.default_rng(0)
    ga = jsynthetic.power_law_graph(
        0, n_nodes=24, n_edges=72, d_feat=cfg.d_in,
        n_classes=getattr(cfg, "n_classes", 3),
        self_loops=arch_name != "equiformer-v2")
    kw = dict(node_feat=ga.node_feat, senders=ga.senders,
              receivers=ga.receivers)
    if arch_name in ("gatedgcn", "meshgraphnet"):
        kw["edge_feat"] = np.ones((ga.n_edges, cfg.d_edge_in), np.float32)
    if arch_name == "meshgraphnet":
        kw["labels"] = rng.standard_normal((ga.n_nodes, cfg.d_out)).astype(
            np.float32)
    elif arch_name == "equiformer-v2":
        pos = rng.standard_normal((ga.n_nodes, 3))
        vecs = pos[ga.senders] - pos[ga.receivers]
        wig = wigner_stack(np.stack([rotation_to_z(v) for v in vecs]),
                           cfg.l_max, m_max=cfg.m_max)
        kw["wigner"] = {l: np.asarray(w, np.float32) for l, w in wig.items()}
        kw["labels"] = rng.standard_normal((1, cfg.d_out)).astype(np.float32)
    else:
        kw["labels"] = ga.labels
    return kw


@pytest.mark.parametrize("arch_name", GNN_ARCHS)
def test_gnn_smoke_train(arch_name):
    jcfg = jget_arch(arch_name).make_smoke_config()
    cfg = get_arch(arch_name).make_smoke_config()
    module = jtrain._GNN_MODULES[arch_name]
    arrays = _gnn_arrays(arch_name, jcfg)
    jg = JGraphBatch(**jax.tree_util.tree_map(jnp.asarray, arrays))
    jparams = module.init_params(jcfg, jax.random.key(1))
    jopt = jadamw(1e-3)

    @jax.jit
    def jstep(p, st, g):
        (_, metrics), grads = jax.value_and_grad(
            lambda q: module.loss_fn(jcfg, q, g), has_aux=True)(p)
        up, st = jopt.update(grads, st, p)
        return japply(p, up), st, metrics

    _, _, jm = jstep(jparams, jopt.init(jparams), jg)
    cell = gnn_train_cell(arch_name, "full_graph_sm", None,
                          _np_tree(jparams), cfg=cfg, device="cpu")
    p2, _, m = cell.step(cell.params, cell.opt_state,
                         GraphBatch(**arrays).to("cpu"))
    assert np.isfinite(float(m["loss"]))
    assert _rel(float(m["loss"]), float(jm["loss"])) < TOL, arch_name
    assert _finite(p2)


def test_dlrm_smoke_train_and_serve():
    jcfg = jget_arch("dlrm-mlperf").make_smoke_config()
    cfg = get_arch("dlrm-mlperf").make_smoke_config()
    jparams = jdlrm.init_params(jcfg, jax.random.key(0))
    batch = jsynthetic.criteo_batch(0, 0, batch=8, n_dense=cfg.n_dense,
                                    vocab_sizes=cfg.vocab_sizes,
                                    multi_hot=cfg.multi_hot)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = jadamw(1e-3)

    @jax.jit
    def jstep(p, st, b):
        (_, metrics), grads = jax.value_and_grad(
            lambda q: jdlrm.loss_fn(jcfg, q, b), has_aux=True)(p)
        up, st = jopt.update(grads, st, p)
        return japply(p, up), st, metrics

    jp2, _, jm = jstep(jparams, jopt.init(jparams), jbatch)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss_fn = params.tree_loss(dlrm.DLRM(cfg, device="cpu"), dlrm.loss_fn)
    opt = adamw(1e-3)
    tree = params.tensor_tree(_np_tree(jparams), device="cpu")
    (p2, _), m = make_step(loss_fn, opt)((tree, opt.init(tree)), tbatch)
    assert _rel(float(m["loss"]), float(jm["loss"])) < TOL
    assert _finite(p2)
    # The forward and the retrieval scores on the reference's updated
    # weights, carried across.
    model = params.load_dlrm(_np_tree(jp2), cfg, device="cpu")
    jlogits = jdlrm.forward(jcfg, jp2, jbatch)
    logits = model({"dense": tbatch["dense"], "sparse": tbatch["sparse"]})
    assert logits.shape == (8,) and bool(torch.isfinite(logits).all())
    assert _rel(logits, jlogits) < TOL
    cands = np.random.default_rng(0).standard_normal(
        (1000, cfg.embed_dim)).astype(np.float32)
    jscores = jdlrm.score_candidates(jcfg, jp2, {"dense": jbatch["dense"][:1]},
                                     jnp.asarray(cands))
    scores = dlrm.score_candidates(model, {"dense": tbatch["dense"][:1]},
                                   torch.from_numpy(cands))
    assert scores.shape == (1000,) and bool(torch.isfinite(scores).all())
    assert _rel(scores, jscores) < TOL


@pytest.mark.parametrize("arch_name", list(REGISTRY))
def test_full_configs_construct(arch_name):
    """The published configs construct (nothing allocated) with the
    reference's parameter counts."""
    arch = get_arch(arch_name)
    cfg = arch.make_config()
    jcfg = jget_arch(arch_name).make_config()
    if arch.family == "lm":
        n = cfg.param_count()
        expected = {"qwen3-moe-30b-a3b": 30e9, "arctic-480b": 480e9,
                    "granite-3-2b": 2.5e9, "gemma2-2b": 2.6e9,
                    "smollm-135m": 135e6}[arch_name]
        assert 0.5 * expected < n < 1.7 * expected, (arch_name, n)
        assert n == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    elif arch.family == "recsys":
        assert cfg.param_count() > 20e9
        assert cfg.param_count() == jcfg.param_count()
    else:
        assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                                   for f in type(cfg).__dataclass_fields__})
