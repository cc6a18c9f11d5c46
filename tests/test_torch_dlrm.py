"""The port's DLRM serving path against the JAX reference model.

Weights come from the reference's ``init_params``, converted with
``np.asarray`` and loaded with ``params.load_dlrm(..., device="cpu")``;
batches from the reference's ``criteo_batch``, which the port's copy must
draw bit for bit.  Everything runs in f32 on the CPU, where the embedding
bags take K6's plain version.  Configs: the reference's smoke config and
DLRM-MLPerf's full widths with every table capped at 1,000 rows.

Tolerance: 1e-5 relative to the largest logit, the reference kernel
tests' f32 tolerance: f32 products summed in another order through two
MLPs and the interaction.  On the card the ``gpu``-marked test holds the
forward (K6) against the same forward on the CPU at the repo's model
tolerance, 1e-4; here it skips.
"""

from dataclasses import asdict
from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import dlrm_mlperf as jdlrm_cfg
from repro.data import synthetic as jsynthetic
from repro.models import common as jcommon
from repro.models import dlrm as jdlrm
from repro_torch import params
from repro_torch.configs import base, dlrm_mlperf
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import common, dlrm

TOL = 1e-5
CAPPED = jdlrm_cfg.make_config(vocab_sizes=tuple(
    min(v, 1000) for v in jdlrm.CRITEO_1TB_VOCABS))
CONFIGS = {"smoke": jdlrm_cfg.make_smoke_config(), "full-width-1000": CAPPED}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _port_cfg(jcfg) -> dlrm.DLRMConfig:
    return dlrm.DLRMConfig(**asdict(jcfg))


@cache
def _reference(name: str):
    jcfg = CONFIGS[name]
    jparams = jdlrm.init_params(jcfg, jax.random.key(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _batch(jcfg, seed=0, step=0, batch=16):
    return jsynthetic.criteo_batch(seed, step, batch=batch,
                                   n_dense=jcfg.n_dense,
                                   vocab_sizes=jcfg.vocab_sizes,
                                   multi_hot=jcfg.multi_hot)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    jcfg, jparams, nparams = _reference(name)
    model = params.load_dlrm(nparams, _port_cfg(jcfg), device="cpu")
    batch = _batch(jcfg, step=3)
    expect = jdlrm.forward(jcfg, jparams,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = dlrm.serve(model, batch)
    assert got.shape == (16,) and got.dtype == np.float32
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_score_candidates_matches_reference(name):
    jcfg, jparams, nparams = _reference(name)
    model = params.load_dlrm(nparams, _port_cfg(jcfg), device="cpu")
    dense = _batch(jcfg, step=1, batch=1)["dense"]
    cand = np.random.default_rng(4).standard_normal(
        (500, jcfg.embed_dim)).astype(np.float32)
    expect = jdlrm.score_candidates(jcfg, jparams,
                                    {"dense": jnp.asarray(dense)},
                                    jnp.asarray(cand))
    got = dlrm.score_candidates(model, {"dense": torch.from_numpy(dense)},
                                torch.from_numpy(cand))
    assert got.dtype == torch.float32 and got.shape == (500,)
    assert _rel(got.numpy(), expect) < TOL


def test_forward_launches_nothing_on_the_cpu():
    jcfg, _, nparams = _reference("smoke")
    model = params.load_dlrm(nparams, _port_cfg(jcfg), device="cpu")
    ops.reset_launches()
    dlrm.serve(model, _batch(jcfg))
    assert ops.LAUNCHES["embedding_bag"] == 0


def test_dot_interaction_pairs_and_order_match_reference():
    f = 27
    iu, ju = jnp.tril_indices(f, k=-1)
    tri = torch.tril_indices(f, f, -1)
    np.testing.assert_array_equal(tri[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(tri[1].numpy(), np.asarray(ju))
    vecs = np.random.default_rng(1).standard_normal((5, f, 16)).astype(
        np.float32)
    expect = jdlrm.dot_interaction(jnp.asarray(vecs))
    got = dlrm.dot_interaction(torch.from_numpy(vecs))
    assert got.shape == (5, f * (f - 1) // 2)
    assert _rel(got.numpy(), expect) < TOL


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_combines_match_reference(combine, weighted):
    rng = np.random.default_rng(6)
    tab = rng.standard_normal((40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, (5, 3)).astype(np.int32)
    w = rng.random((5, 3)).astype(np.float32) if weighted else None
    expect = jdlrm.embedding_bag(
        jnp.asarray(tab), jnp.asarray(idx), combine=combine,
        weights=None if w is None else jnp.asarray(w))
    got = dlrm.embedding_bag(
        torch.from_numpy(tab), torch.from_numpy(idx), combine=combine,
        weights=None if w is None else torch.from_numpy(w))
    assert _rel(got.numpy(), expect) < TOL
    with pytest.raises(ValueError):
        dlrm.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx),
                           combine="max")


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("layer_norm_out", [False, True])
def test_mlp_matches_reference(final_act, layer_norm_out):
    jp = jcommon.mlp_init(jax.random.key(3), (13, 32, 16),
                          layer_norm_out=layer_norm_out)
    x = np.random.default_rng(2).standard_normal((6, 13)).astype(np.float32)
    expect = jcommon.mlp_apply(jp, jnp.asarray(x), final_act=final_act)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    got = common.mlp_apply(tp, torch.from_numpy(x), final_act=final_act)
    assert _rel(got.numpy(), expect) < TOL
    mine = common.mlp_init(np.random.default_rng(0), (13, 32, 16),
                           layer_norm_out=layer_norm_out)
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("seed,step,multi_hot", [(0, 0, 1), (0, 7, 1),
                                                 (3, 2, 1), (5, 1, 4)])
def test_criteo_batch_bit_identical_to_reference(seed, step, multi_hot):
    kw = dict(batch=256, n_dense=13, vocab_sizes=jdlrm.CRITEO_1TB_VOCABS,
              multi_hot=multi_hot)
    expect = jsynthetic.criteo_batch(seed, step, **kw)
    got = synthetic.criteo_batch(seed, step, **kw)
    assert got.keys() == expect.keys()
    for key in expect:
        assert got[key].dtype == expect[key].dtype
        np.testing.assert_array_equal(got[key], expect[key])
    assert got["sparse"].shape == (256, 26, multi_hot)


@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_configs_and_counts_match_reference(make):
    jcfg = getattr(jdlrm_cfg, make)()
    cfg = getattr(dlrm_mlperf, make)()
    assert asdict(cfg) == asdict(jcfg)
    assert cfg.interaction_dim() == jcfg.interaction_dim()
    assert cfg.param_count() == jcfg.param_count()


def test_full_size_counts():
    cfg = dlrm_mlperf.make_config()
    assert cfg.param_count() == 26_137_996_161
    assert cfg.interaction_dim() == 479
    assert sum(cfg.vocab_sizes) == 204_184_588


def test_recsys_shapes_match_reference():
    assert base.RECSYS_SHAPES.keys() == jbase.RECSYS_SHAPES.keys()
    for name, spec in jbase.RECSYS_SHAPES.items():
        got = base.RECSYS_SHAPES[name]
        assert (got.name, got.kind, dict(got.params)) == (
            spec.name, spec.kind, dict(spec.params))


def test_load_dlrm_refuses_wrong_shapes():
    cfg = dlrm_mlperf.make_smoke_config()
    good = params.dlrm_params(cfg, seed=0)
    bad_table = dict(good, tables=list(good["tables"]))
    bad_table["tables"][3] = bad_table["tables"][3][:, :-1]
    bad_w = dict(good, top={"w": list(good["top"]["w"]),
                            "b": good["top"]["b"]})
    bad_w["top"]["w"][0] = bad_w["top"]["w"][0][1:]
    missing = dict(good, tables=good["tables"][:-1])
    short_mlp = dict(good, bot={"w": good["bot"]["w"][:-1],
                                "b": good["bot"]["b"]})
    for broken in (bad_table, bad_w, missing, short_mlp):
        with pytest.raises(ValueError):
            params.load_dlrm(broken, cfg, device="cpu")


def test_seeded_params_follow_the_reference_layout():
    jcfg, _, nparams = _reference("smoke")
    cfg = _port_cfg(jcfg)
    mine = params.dlrm_params(cfg, seed=0)
    assert jax.tree.structure(mine) == jax.tree.structure(nparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(nparams)):
        assert a.shape == b.shape and a.dtype == np.float32
    assert all(not b.any() for b in mine["top"]["b"] + mine["bot"]["b"])
    assert 0.015 < float(np.concatenate(
        [t.ravel() for t in mine["tables"]]).std()) < 0.025


def test_generator_fills_weights_in_place():
    cfg = dlrm_mlperf.make_smoke_config()
    gen = torch.Generator().manual_seed(0)
    model = dlrm.DLRM(cfg, device="cpu", generator=gen)
    tables = torch.cat([t.flatten() for t in model.tables])
    assert 0.015 < float(tables.std()) < 0.025
    w0 = model.bot_w[0]
    assert abs(float(w0.std()) - (2.0 / w0.shape[0]) ** 0.5) < 0.1
    assert not any(b.any() for b in (*model.bot_b, *model.top_b))
    again = dlrm.DLRM(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    out = dlrm.serve(model, synthetic.criteo_batch(
        0, 0, batch=8, n_dense=13, vocab_sizes=cfg.vocab_sizes))
    assert out.shape == (8,) and np.all(np.isfinite(out))


def test_model_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule under test is the CPU one")
    with pytest.raises(RuntimeError, match="CUDA"):
        dlrm.DLRM(dlrm_mlperf.make_smoke_config())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_forward_on_card_matches_cpu(cuda_device):
    """Full widths, tables capped at 1,000 rows: the card's forward (K6,
    26 launches) against the CPU's (plain), at the repo's model
    tolerance."""
    jcfg, _, nparams = _reference("full-width-1000")
    cfg = _port_cfg(jcfg)
    batch = _batch(jcfg, step=2, batch=512)
    ops.reset_launches()
    on_card = dlrm.serve(params.load_dlrm(nparams, cfg, device=cuda_device),
                         batch)
    assert ops.LAUNCHES["embedding_bag"] == cfg.n_sparse
    on_cpu = dlrm.serve(params.load_dlrm(nparams, cfg, device="cpu"), batch)
    assert _rel(on_card, on_cpu) < 1e-4
