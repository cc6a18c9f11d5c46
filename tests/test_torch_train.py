"""The port's training path held to the reference's on the CPU: chunked
attention, the losses and their gradients, DLRM through K6's autograd
``Function``, five train steps from the reference's weights, the carry of
weights back into the reference's layout, and ``launch.train``'s runs.

Weights come from the reference's ``init_params`` (``np.asarray`` leaf by
leaf) and enter the port as a tree of tensors in the same layout, so both
packages start from the same numbers.  Tolerances: forward values and
losses 1e-5, gradients 1e-4 (each leaf's error relative to its largest
entry, or to 1% of the tree's largest where a leaf is near zero), and the
five-step trajectories 1e-4 in losses and every parameter and moment.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import dlrm as jdlrm
from repro.models import transformer as jtr
from repro.models.moe import MoEConfig as JMoEConfig
from repro_torch import params
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import attention, common, dlrm
from repro_torch.models import transformer as tr
from repro_torch.models.moe import MoEConfig
from repro_torch.tree import (tree_flatten, tree_leaves, tree_unflatten,
                              value_and_grad)

CPU = torch.device("cpu")
TOL_VALUE, TOL_GRAD, TOL_STEPS = 1e-5, 1e-4, 1e-4


def _np_tree(jtree):
    return jax.tree_util.tree_map(np.asarray, jtree)


def _rel(got, want, floor=0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), floor, 1e-30)
    return float(np.abs(got - want).max(initial=0.0)) / scale


def _same_leaves(got_tree, want_tree, tol, label, share=1e-2):
    got = [np.asarray(x) for x in tree_leaves(params.to_numpy(got_tree))]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want_tree)]
    assert len(got) == len(want), label
    top = max(float(np.abs(w).max(initial=0.0)) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (label, i)
        err = _rel(g, w, share * top)
        assert err < tol, (label, i, err)


# ---------------------------------------------------------------------------
# Chunked attention and the cross-entropy
# ---------------------------------------------------------------------------

ATTN_CASES = {  # (b, s, h, hk, d, window, softcap, q_chunk)
    "causal": (2, 32, 4, 4, 8, None, None, 8),
    "gqa-window-softcap": (2, 48, 6, 2, 8, 12, 30.0, 16),
    "single-block": (1, 20, 2, 1, 16, None, 50.0, 64),
    "budget-halves": (2, 64, 2, 2, 8, 24, None, 64),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_and_grads_match_the_reference(case):
    b, s, h, hk, d, window, cap, q_chunk = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)))
    # A budget of one 8-row chunk's scores makes the chunk halve.
    budget = b * h * s * 4 * 8 if case == "budget-halves" else 1 << 29
    kw = dict(window=window, attn_softcap=cap, q_chunk=q_chunk,
              score_budget_bytes=budget)

    def jf(q, k, v):
        return jnp.sum(jattn.chunked_causal_attention(q, k, v, **kw) * ct)

    jout = jax.jit(partial(jattn.chunked_causal_attention, **kw))(q, k, v)
    jgrads = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.chunked_causal_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    assert _rel(out.detach(), jout) < TOL_VALUE
    for t, j in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad, j) < TOL_VALUE, case


def test_chunked_attention_returns_the_input_dtype():
    q = torch.randn(1, 16, 2, 8, dtype=torch.bfloat16)
    out = attention.chunked_causal_attention(q, q, q, q_chunk=4)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_the_reference(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32) if masked else None
    want = jcommon.cross_entropy_loss(
        logits, labels, mask=None if mask is None else jnp.asarray(mask))
    got = common.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask))
    assert _rel(got, want) < TOL_VALUE
    assert common.count_params({"a": np.zeros((2, 3)), "b": [torch.ones(4)]}) \
        == 10


# ---------------------------------------------------------------------------
# The transformer loss and its gradients
# ---------------------------------------------------------------------------

def _port_cfg(jcfg) -> tr.TransformerConfig:
    kw = {f: getattr(jcfg, f) for f in tr.TransformerConfig.__dataclass_fields__}
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**{f: getattr(jcfg.moe, f)
                                 for f in MoEConfig.__dataclass_fields__})
    return tr.TransformerConfig(**kw)


LM_CASES = {  # (reference config, batch, seq)
    "smollm-smoke": (jget_arch("smollm-135m").make_smoke_config(), 2, 32),
    "tiny-moe": (jtr.TransformerConfig(
        name="tiny-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, vocab=128,
        moe=JMoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                       capacity_factor=1.0, dense_residual_d_ff=32),
        dtype="float32", q_chunk=8), 2, 16),
    "gemma2-smoke": (jget_arch("gemma2-2b").make_smoke_config(), 2, 24),
    # b * s * vocab = 2^25 > 2^24 and S % 256 == 0: the chunked CE.
    "chunked-ce": (jtr.TransformerConfig(
        name="chunked-ce", n_layers=2, d_model=16, n_heads=2, n_kv_heads=1,
        d_head=8, d_ff=32, vocab=32768, window_pattern=(64, None),
        final_softcap=30.0, dtype="float32", q_chunk=128), 2, 512),
    "no-remat": (jget_arch("smollm-135m").make_smoke_config(remat="none"),
                 2, 32),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_transformer_loss_and_grads_match_the_reference(case):
    jcfg, b, s = LM_CASES[case]
    cfg = _port_cfg(jcfg)
    jparams = jtr.init_params(jcfg, jax.random.key(3))
    batch = synthetic.lm_batch(0, 1, batch=b, seq=s, vocab=jcfg.vocab)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(jcfg, p, batch), has_aux=True))(jparams)
    tparams = params.tensor_tree(_np_tree(jparams), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, metrics), grads = value_and_grad(partial(tr.loss_fn, cfg))(
        tparams, tbatch)
    assert _rel(loss, jloss) < TOL_VALUE
    for key in ("ce", "aux"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= \
            TOL_VALUE * max(abs(float(jmetrics[key])), 1.0), key
    if cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    _same_leaves(grads, jgrads, TOL_GRAD, case)


def test_forward_hidden_serving_path_is_unchanged():
    """The serving forward still runs K5's plain version here, under
    inference mode, and the training hidden state agrees with it."""
    jcfg, b, s = LM_CASES["smollm-smoke"]
    cfg = _port_cfg(jcfg)
    p_np = _np_tree(jtr.init_params(jcfg, jax.random.key(3)))
    tokens = torch.from_numpy(synthetic.lm_batch(0, 1, batch=b, seq=s,
                                                 vocab=cfg.vocab)["tokens"])
    model = params.load_transformer(p_np, cfg, device="cpu")
    served, _ = tr.forward_hidden(cfg, model, tokens)
    assert served.is_inference()
    trained, _ = tr._train_hidden(cfg, params.tensor_tree(p_np, device="cpu"),
                                  tokens)
    assert _rel(trained.detach(), served) < TOL_VALUE


# ---------------------------------------------------------------------------
# DLRM through K6's autograd Function
# ---------------------------------------------------------------------------

def test_embedding_bag_function_gradient_is_the_transposed_gather():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (9, 4)).astype(np.int32))
    ids[0] = 3  # one id four times in a bag
    ct = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    t1 = table.clone().requires_grad_()
    out = ops.embedding_bag_autograd(t1, ids)
    (out * ct).sum().backward()
    t2 = table.clone().requires_grad_()
    (t2[ids.long()].sum(dim=1) * ct).sum().backward()
    assert torch.equal(out.detach(), eb.embedding_bag_plain(table, ids))
    assert _rel(t1.grad, t2.grad) < TOL_VALUE
    # The raw kernel's plain version keeps its guard.
    with pytest.raises(ValueError, match="no backward"):
        ops.embedding_bag(t1, ids)


def test_dlrm_loss_and_grads_match_the_reference():
    jcfg = jget_arch("dlrm-mlperf").make_smoke_config()
    cfg = get_arch("dlrm-mlperf").make_smoke_config()
    jparams = jdlrm.init_params(jcfg, jax.random.key(1))
    batch = synthetic.criteo_batch(0, 0, batch=64, n_dense=13,
                                   vocab_sizes=cfg.vocab_sizes)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdlrm.loss_fn(jcfg, p, batch), has_aux=True))(jparams)
    loss_fn = params.tree_loss(dlrm.DLRM(cfg, device="cpu"), dlrm.loss_fn)
    ops.reset_launches()
    (loss, m), grads = value_and_grad(loss_fn)(
        params.tensor_tree(_np_tree(jparams), device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ops.LAUNCHES["embedding_bag"] == 0   # the CPU takes the plain bag
    assert _rel(loss, jloss) < TOL_VALUE
    assert float(m["acc"]) == float(jm["acc"])
    _same_leaves(grads, jgrads, TOL_VALUE, "dlrm grads")


# ---------------------------------------------------------------------------
# Weights carried back into the reference's layout
# ---------------------------------------------------------------------------

def _gnn_ref_params(name):
    jarch = jget_arch(name)
    jcfg = jarch.make_smoke_config()
    module = jtrain._GNN_MODULES[name]
    return jcfg, _np_tree(module.init_params(jcfg, jax.random.key(0)))


DUMPS = ["smollm-smoke", "tiny-moe", "gemma2-smoke", "dlrm", "gcn-cora",
         "gatedgcn", "meshgraphnet", "equiformer-v2"]


@pytest.mark.parametrize("case", DUMPS)
def test_dump_is_the_reverse_of_load(case):
    if case in LM_CASES:
        jcfg = LM_CASES[case][0]
        cfg = _port_cfg(jcfg)
        ref = _np_tree(jtr.init_params(jcfg, jax.random.key(0)))
        model = params.load_transformer(ref, cfg, device="cpu",
                                        dtype=torch.float32)
        got = params.dump_transformer(model)
    elif case == "dlrm":
        cfg = get_arch("dlrm-mlperf").make_smoke_config()
        ref = _np_tree(jdlrm.init_params(
            jget_arch("dlrm-mlperf").make_smoke_config(), jax.random.key(0)))
        got = params.dump_dlrm(params.load_dlrm(ref, cfg, device="cpu"))
    else:
        _, ref = _gnn_ref_params(case)
        cfg = get_arch(case).make_smoke_config()
        load = {"gcn-cora": params.load_gcn, "gatedgcn": params.load_gatedgcn,
                "meshgraphnet": params.load_meshgraphnet,
                "equiformer-v2": params.load_equiformer_v2}[case]
        got = params.dump_gnn(load(ref, cfg, device="cpu"))
    g_leaves, g_def = tree_flatten(got)
    w_leaves = jax.tree_util.tree_leaves(ref)
    assert len(g_leaves) == len(w_leaves)
    assert tree_flatten(ref)[1] == g_def
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_bind_reads_stacked_leaves_and_dump_refuses_other_models():
    _, ref = _gnn_ref_params("gatedgcn")
    cfg = get_arch("gatedgcn").make_smoke_config()
    tree = params.tensor_tree(ref, device="cpu")
    bound = params.bind(params.load_gatedgcn(ref, cfg, device="cpu"), tree)
    assert torch.equal(bound["layers.1.A"], tree["layers"]["A"][1])
    assert bound["embed_h"] is tree["embed_h"]
    with pytest.raises(TypeError):
        params.dump_gnn(dlrm.DLRM(get_arch("dlrm-mlperf").make_smoke_config(),
                                  device="cpu"))


# ---------------------------------------------------------------------------
# Five train steps from the reference's weights
# ---------------------------------------------------------------------------

def _args(ref: bool, arch: str, *extra):
    argv = ["--arch", arch, "--steps", "5", "--lr", "3e-3", *extra]
    if ref:
        return jtrain.build_parser().parse_args(argv)
    return train.build_parser().parse_args(argv + ["--device", "cpu"])


def _carried(port_state, jstate):
    """The reference's state in the port's structure, leaf for leaf (which
    holds only if both flatten alike)."""
    leaves, treedef = tree_flatten(port_state)
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(leaves) == len(jleaves)
    out = []
    for p, j in zip(leaves, jleaves):
        t = torch.from_numpy(np.array(j))
        assert tuple(t.shape) == tuple(p.shape) and t.dtype == p.dtype
        out.append(t)
    return tree_unflatten(treedef, out)


@pytest.mark.parametrize("arch,extra", [
    ("smollm-135m", ("--batch", "4", "--seq", "32")),
    ("gcn-cora", ()),
    ("dlrm-mlperf", ("--batch", "64")),
    ("meshgraphnet", ("--gnn-nodes", "64", "--gnn-edges", "256")),
])
def test_five_train_steps_match_the_reference(arch, extra):
    jarch, tarch = jget_arch(arch), get_arch(arch)
    setup = {"lm": "_lm_setup", "gnn": "_gnn_setup",
             "recsys": "_dlrm_setup"}[tarch.family]
    jstate, jstep, jbatch = getattr(jtrain, setup)(jarch, _args(True, arch,
                                                                *extra))
    tstate, tstep, tbatch = getattr(train, setup)(
        tarch, _args(False, arch, *extra), CPU)
    tstate = _carried(tstate, jstate)
    for step in range(5):
        jstate, jm = jstep(jstate, jbatch(step))
        tstate, tm = tstep(tstate, tbatch(step))
        assert _rel(float(tm["loss"]), float(jm["loss"])) < TOL_STEPS, step
    assert int(tstate[1].step) == 5
    _same_leaves(tstate, jstate, TOL_STEPS, arch)


def test_make_train_step_is_the_trainers_lm_step():
    """``transformer.make_train_step``, the reference's signature, takes
    the same steps as the trainer's LM step, bit for bit."""
    args = _args(False, "smollm-135m", "--batch", "2", "--seq", "32")
    arch = get_arch("smollm-135m")
    state, step_fn, batch_fn = train._lm_setup(arch, args, CPU)
    copy = (tree_unflatten(tree_flatten(state)[1],
                           [t.clone() for t in tree_leaves(state)]))
    train_step = tr.make_train_step(arch.make_smoke_config(),
                                    step_fn.optimizer)
    params_, opt_state = copy
    for step in range(2):
        state, m = step_fn(state, batch_fn(step))
        params_, opt_state, m2 = train_step(params_, opt_state,
                                            batch_fn(step))
        assert float(m["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(state), tree_leaves((params_, opt_state))))


# ---------------------------------------------------------------------------
# launch.train: the trainer's runs
# ---------------------------------------------------------------------------

def _run(tmp_path, name, *argv):
    args = train.build_parser().parse_args(
        list(argv) + ["--device", "cpu", "--ckpt-dir", str(tmp_path / name)])
    return train.train(args)


@pytest.mark.parametrize("arch", ["smollm-135m", "gcn-cora", "dlrm-mlperf"])
def test_run_loss_falls_and_rollback_replays_exactly(tmp_path, arch):
    argv = ("--arch", arch, "--steps", "12", "--checkpoint-every", "4",
            "--lr", "1e-2")
    _, clean = _run(tmp_path, "clean", *argv)
    state, failed = _run(tmp_path, "failed", *argv, "--fail-at", "6")
    assert clean[-1]["loss"] < clean[0]["loss"]
    # Steps 4 and 5 run twice: before the failure and after the rollback.
    assert [h["step"] for h in failed] == list(range(6)) + list(range(4, 12))
    strip = lambda hist: [{k: v for k, v in h.items() if k != "dt"}
                          for h in hist]
    assert strip(failed[6:]) == strip(clean[4:])
    assert strip(failed[:6]) == strip(clean[:6])
    assert int(state[1].step) == 12


def test_compressed_run_converges_like_uncompressed(tmp_path):
    """``--compress-grads`` wraps the LM trainer's AdamW (the reference
    wraps only that one) and converges like the uncompressed run."""
    argv = ("--arch", "smollm-135m", "--steps", "20", "--checkpoint-every",
            "100", "--batch", "2", "--seq", "32")
    plain = train.run(train.build_parser().parse_args(
        list(argv) + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "a")]))
    state, comp = _run(tmp_path, "b", *argv, "--compress-grads")
    assert type(state[1]).__name__ == "CompressedState"
    assert comp != plain
    assert comp[-1]["loss"] < comp[0]["loss"]
    assert comp[-1]["loss"] < plain[-1]["loss"] * 1.2 + 1e-3


def test_cli_runs_on_the_cpu_and_refuses_without_a_card(tmp_path, capsys):
    assert not torch.cuda.is_available()
    assert train.main(["--arch", "gcn-cora", "--steps", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert train.main(["--arch", "gcn-cora", "--steps", "3", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000003"]
    with pytest.raises(SystemExit):
        train.build_parser().parse_args(["--arch", "x", "--device", "tpu"])
