"""The port's training substrate held to the reference's: the tree order,
the optimizers and schedules, gradient compression, checkpoints (the
reference's layout, restored across both packages), the resilient loop and
the synthetic LM stream.  Twins of ``tests/test_substrate.py`` on the CPU,
plus parity with the reference on the same seeded inputs."""

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis; pip install hypothesis")
from hypothesis import given, settings, strategies as st

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data import synthetic as jsynthetic
from repro.optim import compression as jcompression
from repro.optim import optimizers as joptim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.distributed.resilience import (FaultInjector, StepMonitor,
                                                WorkerFailure, run_resilient)
from repro_torch.optim import compression, optimizers as optim
from repro_torch.optim.compression import compress_decompress, wrap_optimizer
from repro_torch.optim.optimizers import (adamw, apply_updates, global_norm,
                                          sgd)
from repro_torch import params as tparams
from repro_torch import tree


def _tree_np(seed=0) -> dict:
    """A seeded tree whose dict keys sort otherwise than they were written,
    with a list and a NamedTuple-free nesting, as numpy f32."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "nested": {"z": rng.standard_normal((3, 2)).astype(np.float32),
                       "a": [rng.standard_normal(5).astype(np.float32),
                             rng.standard_normal((2, 2)).astype(np.float32)]}}


def _t(tree_np):
    return tree.tree_map(torch.from_numpy, tree_np)


def _j(tree_np):
    return jax.tree_util.tree_map(jnp.asarray, tree_np)


# ---------------------------------------------------------------------------
# Trees in the reference's order
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    second: object
    first: object


def test_tree_flatten_order_matches_jax():
    t = {"b": [np.float32(1), (np.float32(2), None)], "a": np.float32(3),
         "c": _Pair(np.float32(4), {"y": np.float32(5), "x": np.float32(6)})}
    leaves, treedef = tree.tree_flatten(t)
    assert leaves == jax.tree_util.tree_leaves(t)
    assert repr(treedef).count("*") == len(leaves)
    back = tree.tree_unflatten(treedef, leaves)
    assert isinstance(back["c"], _Pair) and back["b"][1][1] is None
    assert tree.tree_leaves(back) == leaves


def test_tree_map_and_value_and_grad():
    params = _t(_tree_np())
    doubled = tree.tree_map(lambda x, y: x + y, params, params)
    assert torch.equal(doubled["nested"]["a"][1], 2 * params["nested"]["a"][1])
    with pytest.raises(ValueError):
        tree.tree_map(lambda x, y: x, params, {"w": params["w"]})

    def loss(p, k):
        return k * (p["w"].sum() + p["b"].square().sum()), {"k": k}

    (value, aux), grads = tree.value_and_grad(loss)(params, 3.0)
    assert float(value) == pytest.approx(
        3 * float(params["w"].sum() + params["b"].square().sum()), rel=1e-6)
    assert aux == {"k": 3.0}
    assert torch.equal(grads["w"], torch.full((8, 4), 3.0))
    assert torch.allclose(grads["b"], 6 * params["b"])
    assert torch.equal(grads["nested"]["z"], torch.zeros(3, 2))  # unused


# ---------------------------------------------------------------------------
# Checkpointing (twins of the reference's tests)
# ---------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g), "b": torch.arange(4.0),
            "nested": {"s": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _ckpt_tree()
    mgr.save(7, t)
    step, restored = mgr.restore(tree.tree_map(torch.zeros_like, t))
    assert step == 7
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _ckpt_tree(s))
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _ckpt_tree())
    with pytest.raises(ValueError):
        mgr.restore({"only": torch.zeros(2)})
    with pytest.raises(ValueError):
        mgr.restore({"b": torch.zeros(4), "nested": {"s": torch.zeros(())},
                     "w": torch.zeros(4, 8)})


def test_checkpoint_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _ckpt_tree())
    assert not list(Path(tmp_path).glob("*.tmp"))
    assert sorted(p.name for p in (tmp_path / "step_000000005").iterdir()) \
        == ["arrays.npz", "manifest.json"]


def test_elastic_restore_onto_a_device(tmp_path):
    """Leaves land on the ``device`` asked for, in the ``like`` leaves'
    dtypes (the reference takes per-leaf shardings instead)."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"w": torch.arange(64.0).reshape(8, 8)})
    step, out = mgr.restore({"w": torch.zeros(8, 8, dtype=torch.float64)},
                            device="cpu")
    assert step == 3 and out["w"].device.type == "cpu"
    assert out["w"].dtype == torch.float64
    assert float(out["w"].sum()) == float(sum(range(64)))


def _adamw_state_pair(seed=0):
    """The same (params, AdamW state) in both packages, after one update
    so that no leaf is zero."""
    p_np = _tree_np(seed)
    g_np = _tree_np(seed + 1)
    jopt, topt = joptim.adamw(1e-2, weight_decay=0.1), adamw(1e-2,
                                                            weight_decay=0.1)
    jp, tp = _j(p_np), _t(p_np)
    ju, js = jopt.update(_j(g_np), jopt.init(jp), jp)
    tu, ts = topt.update(_t(g_np), topt.init(tp), tp)
    return ((joptim.apply_updates(jp, ju), js),
            (apply_updates(tp, tu), ts))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _adamw_state_pair()
    CheckpointManager(tmp_path).save(4, tstate)
    step, restored = JCheckpointManager(tmp_path).restore(jstate)
    assert step == 4
    got = jax.tree_util.tree_leaves(restored)
    want = tree.tree_leaves(tparams.to_numpy(tstate))
    assert len(got) == len(want) == len(jax.tree_util.tree_leaves(jstate))
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert isinstance(restored[1], joptim.AdamWState)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _adamw_state_pair()
    JCheckpointManager(tmp_path).save(9, jstate)
    step, restored = CheckpointManager(tmp_path).restore(tstate)
    assert step == 9 and isinstance(restored[1], optim.AdamWState)
    for a, b in zip(tree.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Resilience (twins)
# ---------------------------------------------------------------------------

def test_resilient_loop_recovers_from_faults(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        return state + 1, {"loss": 100 - state}

    inj = FaultInjector(frozenset({7, 13}))
    state, hist = run_resilient(
        state=torch.tensor(0), step_fn=step_fn, batch_fn=lambda s: s,
        n_steps=20, checkpoint_manager=mgr, checkpoint_every=5,
        injector=inj, log_every=0)
    assert int(state) == 20
    assert [h["step"] for h in hist][-1] == 19
    assert mgr.latest_step() == 20
    # Rolled back to 5 at step 7 and to 10 at step 13: the batches replay.
    assert calls == list(range(7)) + list(range(5, 13)) + list(range(10, 20))
    assert all(isinstance(h["loss"], float) for h in hist)


def test_resilient_loop_without_checkpoint_keeps_its_state():
    """The reference's quirk: with no checkpoint yet, a failure resets the
    step to 0 and keeps the state reached so far."""
    state, hist = run_resilient(
        state=torch.tensor(0), step_fn=lambda s, b: (s + 1, {"s": s}),
        batch_fn=lambda s: s, n_steps=4,
        injector=FaultInjector(frozenset({2})), log_every=0)
    assert int(state) == 6
    assert [h["step"] for h in hist] == [0, 1, 0, 1, 2, 3]
    assert [h["s"] for h in hist] == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    class AlwaysFail(FaultInjector):
        def check(self, step):
            if step == 2:
                raise WorkerFailure("persistent fault")

    with pytest.raises(WorkerFailure):
        run_resilient(state=torch.tensor(0),
                      step_fn=lambda s, b: (s + 1, {}),
                      batch_fn=lambda s: None, n_steps=5,
                      checkpoint_manager=CheckpointManager(tmp_path),
                      checkpoint_every=100, injector=AlwaysFail(),
                      max_restarts=2, log_every=0)


def test_straggler_monitor_flags_slow_steps():
    seen = []
    mon = StepMonitor(threshold=2.0, on_straggler=lambda *a: seen.append(a))
    for s in range(10):
        mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)
    assert mon.stragglers == [10] and seen[0][:2] == (10, 1.0)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def test_compression_error_feedback_contracts():
    g = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    err = torch.zeros(1000)
    deq, err2 = compress_decompress(g, err)
    scale = float(g.abs().max()) / 127.0
    assert float(err2.abs().max()) <= scale * 0.5 + 1e-6
    assert torch.allclose(deq + err2, g, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_decompress_is_bit_identical_to_the_reference(dtype):
    rng = np.random.default_rng(3)
    g32 = (rng.standard_normal(4096) * 3).astype(np.float32)
    g32[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, 0.0, -3.5]  # round ties
    err = (rng.standard_normal(4096) * 1e-2).astype(np.float32)
    if dtype == "bfloat16":
        tg = torch.from_numpy(g32).bfloat16()
        jg = jnp.asarray(g32).astype(jnp.bfloat16)
    else:
        tg, jg = torch.from_numpy(g32), jnp.asarray(g32)
    for _ in range(3):  # carry the error feedback forward
        (td, te), (jd, je) = (compress_decompress(tg, torch.from_numpy(err)),
                              jcompression.compress_decompress(
                                  jg, jnp.asarray(err)))
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd.astype(jnp.float32)))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        err = te.numpy()


def test_compressed_training_converges_like_uncompressed():
    """Least squares with/without compression reach similar loss."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(64).astype(np.float32))

    def loss(w):
        return torch.mean((A @ w - y) ** 2), {}

    grad = tree.value_and_grad(loss)

    def run(opt):
        w = torch.zeros(8)
        state = opt.init(w)
        for _ in range(200):
            _, g = grad(w)
            up, state = opt.update(g, state, w)
            w = apply_updates(w, up)
        return float(loss(w)[0])

    plain = run(sgd(0.05, momentum=0.0))
    comp = run(wrap_optimizer(sgd(0.05, momentum=0.0)))
    assert comp < plain * 1.2 + 1e-3, (plain, comp)


def test_wrapped_optimizer_matches_the_reference():
    p_np, jopt = _tree_np(0), jcompression.wrap_optimizer(
        joptim.adamw(1e-2, weight_decay=0.1))
    topt = compression.wrap_optimizer(adamw(1e-2, weight_decay=0.1))
    jp, tp = _j(p_np), _t(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(3):
        g_np = _tree_np(10 + k)
        ju, js = jopt.update(_j(g_np), js, jp)
        tu, ts = topt.update(_t(g_np), ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), apply_updates(tp, tu)
    for a, b in zip(tree.tree_leaves(tparams.to_numpy((tp, ts))),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------

def test_adamw_reduces_quadratic():
    def loss(w):
        return torch.sum((w - 3.0) ** 2), {}

    opt = adamw(0.1)
    w = torch.zeros(4)
    state = opt.init(w)
    for _ in range(100):
        _, g = tree.value_and_grad(loss)(w)
        up, state = opt.update(g, state, w)
        w = apply_updates(w, up)
    assert float(loss(w)[0]) < 0.05


@settings(max_examples=20, deadline=None)
@given(st.floats(0.1, 10.0))
def test_clip_bounds_global_norm(max_norm):
    g = {"a": torch.full((10,), 5.0), "b": torch.full((3, 3), -2.0)}
    clipped, norm = optim.clip_by_global_norm(g, max_norm)
    assert float(global_norm(clipped)) <= max_norm * 1.001
    jclipped, jnorm = joptim.clip_by_global_norm(
        {"a": jnp.full((10,), 5.0), "b": jnp.full((3, 3), -2.0)}, max_norm)
    assert float(norm) == float(jnorm)
    for a, b in zip(tree.tree_leaves(clipped),
                    jax.tree_util.tree_leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_schedules_match_the_reference_within_one_ulp():
    """Every rate within 1 f32 ulp of the reference's, but where it reads
    cos(pi t): PyTorch's and XLA's f32 ``cos`` differ by up to an ulp of
    the cosine, which ``1 + cos`` magnifies as the cosine nears -1 (up to
    3 ulps of the rate at t -> 1).  There the rates must agree within what
    one ulp of cos(pi t) moves them, plus one ulp of the rate."""
    steps = np.arange(0, 140, dtype=np.int32)
    base, warmup, total, frac = 3e-3, 20, 120, 0.1
    got = optim.cosine_schedule(base, warmup, total)(
        torch.from_numpy(steps)).numpy()
    want = np.asarray(joptim.cosine_schedule(base, warmup, total)(
        jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    flat = (steps <= warmup) | (steps >= total)
    assert int(_ulps(got[flat], want[flat]).max()) <= 1
    t = np.clip((steps - warmup) / (total - warmup), 0, 1).astype(np.float32)
    cos = np.cos(np.float32(np.pi) * t).astype(np.float32)
    moved = base * (1 - frac) * 0.5 * np.spacing(np.abs(cos))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= moved + np.spacing(want)).all(), err.max()
    got = optim.linear_warmup(base, warmup)(torch.from_numpy(steps)).numpy()
    want = np.asarray(joptim.linear_warmup(base, warmup)(jnp.asarray(steps)))
    assert int(_ulps(got, want).max()) <= 1


@pytest.mark.parametrize("case", ["clip", "noclip-wd", "cosine-donate",
                                  "bf16-state"])
def test_adamw_update_matches_the_reference(case):
    kw = {"clip": dict(lr=1e-2),
          "noclip-wd": dict(lr=1e-2, weight_decay=0.1, clip_norm=None),
          "cosine-donate": dict(weight_decay=0.1),
          "bf16-state": dict(lr=1e-2, weight_decay=0.1)}[case]
    jkw, tkw = dict(kw), dict(kw)
    if case == "cosine-donate":
        jkw["lr"] = joptim.cosine_schedule(3e-3, warmup=2, total=10)
        tkw["lr"] = optim.cosine_schedule(3e-3, warmup=2, total=10)
        tkw["donate"] = True
    if case == "bf16-state":
        jkw["state_dtype"], tkw["state_dtype"] = jnp.bfloat16, torch.bfloat16
    jopt, topt = joptim.adamw(**jkw), adamw(**tkw)
    p_np = _tree_np(0)
    jp, tp = _j(p_np), _t(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(4):
        g_np = tree.tree_map(lambda a: a * 5, _tree_np(20 + k))
        ju, js = jopt.update(_j(g_np), js, jp)
        tu, ts = topt.update(_t(g_np), ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = apply_updates(tp, tu, donate=topt.donate)
    assert int(ts.step) == 4 and ts.mu["w"].dtype == tkw.get(
        "state_dtype", torch.float32)
    for a, b in zip(tree.tree_leaves(tparams.to_numpy(
            tree.tree_map(lambda x: x.float(), (tp, ts)))),
            jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda x: x.astype(jnp.float32)
                                       if x.dtype == jnp.bfloat16 else x,
                                       (jp, js)))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8)


def test_adamw_donate_spends_its_inputs_and_matches():
    p_np, g_np = _tree_np(0), _tree_np(1)
    out = []
    for donate in (False, True):
        opt = adamw(1e-2, weight_decay=0.1, donate=donate)
        p = _t(tree.tree_map(np.copy, p_np))
        state = opt.init(p)
        mu_w = state.mu["w"]
        grads = _t(tree.tree_map(np.copy, g_np))
        updates, state = opt.update(grads, state, p)
        new = apply_updates(p, updates, donate=donate)
        assert (state.mu["w"] is mu_w) == donate
        assert (new["w"] is p["w"]) == donate
        assert (updates["w"] is grads["w"]) == donate
        out.append(tparams.to_numpy((new, state)))
    for a, b in zip(tree.tree_leaves(out[0]), tree.tree_leaves(out[1])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        adamw(donate=True, state_dtype=torch.bfloat16)


def test_sgd_matches_the_reference():
    p_np = _tree_np(0)
    jopt = joptim.sgd(0.05, momentum=0.9, clip_norm=1.0)
    topt = sgd(0.05, momentum=0.9, clip_norm=1.0)
    jp, tp = _j(p_np), _t(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(3):
        g_np = _tree_np(30 + k)
        ju, js = jopt.update(_j(g_np), js, jp)
        tu, ts = topt.update(_t(g_np), ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), apply_updates(tp, tu)
    for a, b in zip(tree.tree_leaves(tparams.to_numpy((tp, ts))),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

def test_synthetic_determinism():
    b1 = synthetic.lm_batch(0, 5, batch=2, seq=8, vocab=100)
    b2 = synthetic.lm_batch(0, 5, batch=2, seq=8, vocab=100)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    b3 = synthetic.criteo_batch(0, 5, batch=4, n_dense=13,
                                vocab_sizes=(10, 20, 30))
    b4 = synthetic.criteo_batch(0, 5, batch=4, n_dense=13,
                                vocab_sizes=(10, 20, 30))
    assert np.array_equal(b3["sparse"], b4["sparse"])
    assert (b3["sparse"] < np.array([10, 20, 30])[None, :, None]).all()


@pytest.mark.parametrize("seed,step,batch,seq,vocab",
                         [(0, 0, 2, 8, 100), (3, 17, 4, 128, 256),
                          (1, 5, 8, 64, 49152)])
def test_lm_batch_is_bit_identical_to_the_reference(seed, step, batch, seq,
                                                    vocab):
    got = synthetic.lm_batch(seed, step, batch=batch, seq=seq, vocab=vocab)
    want = jsynthetic.lm_batch(seed, step, batch=batch, seq=seq, vocab=vocab)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Neighbor sampler (twins of tests/test_substrate.py's sampler tests)
# ---------------------------------------------------------------------------
def test_sampler_respects_fanout_and_membership():
    from repro_torch.data.sampler import build_csr, sample_subgraph
    rng = np.random.default_rng(0)
    ga = synthetic.power_law_graph(0, n_nodes=500, n_edges=4000, d_feat=4,
                                   self_loops=False)
    csr = build_csr(ga.senders, ga.receivers, 500)
    seeds = rng.choice(500, 32, replace=False)
    sub = sample_subgraph(csr, seeds, (5, 3), rng=rng, n_pad=1024,
                          e_pad=1024)
    assert sub.n_real_nodes <= 32 + 32 * 5 + 32 * 5 * 3
    assert sub.n_real_edges <= 32 * 5 + 32 * 5 * 3
    edge_set = set(zip(ga.senders.tolist(), ga.receivers.tolist()))
    for i in range(sub.n_real_edges):
        s_g = int(sub.node_ids[sub.senders[i]])
        r_g = int(sub.node_ids[sub.receivers[i]])
        assert (s_g, r_g) in edge_set
    assert np.array_equal(sub.node_ids[:32], seeds)
    assert sub.seed_mask[:32].sum() == 32


def test_sampler_determinism():
    from repro_torch.data.sampler import build_csr, sample_subgraph
    ga = synthetic.power_law_graph(1, n_nodes=300, n_edges=2000, d_feat=4)
    csr = build_csr(ga.senders, ga.receivers, 300)
    seeds = np.arange(16)
    s1 = sample_subgraph(csr, seeds, (4, 2),
                         rng=np.random.default_rng(42), n_pad=512, e_pad=512)
    s2 = sample_subgraph(csr, seeds, (4, 2),
                         rng=np.random.default_rng(42), n_pad=512, e_pad=512)
    assert np.array_equal(s1.senders, s2.senders)
    assert np.array_equal(s1.node_ids, s2.node_ids)
