"""The port's MoE layer against the JAX reference (``repro.models.moe``).

The same inputs go to both: the reference's ``init_moe_params`` output
converted with ``np.asarray``, and seeded numpy tokens.  The first five
tests twin ``tests/test_moe.py`` (each also held to the reference); the
rest hold the routing, the assignment packing and both FFN paths to the
reference at the published routing (128 experts, top-8) at narrow widths
(d 64, f 32), with capacity factors that drop.

Tolerances: the packing's token, expert, slot and keep arrays are
bit-identical and the router's indices equal (a flipped choice would move
later slots); gates and the balance loss within 1e-6; outputs within 1e-5
in f32 and 3e-2 in bf16 relative to the largest, the reference's own
(``tests/test_kernels.py``); gradients within 1e-4 of ``jax.grad``'s.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis; pip install hypothesis")
from hypothesis import given, settings, strategies as st

from repro.models import moe as jmoe
from repro_torch.models import moe

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _port_cfg(jcfg) -> moe.MoEConfig:
    return moe.MoEConfig(**{f.name: getattr(jcfg, f.name)
                            for f in fields(jcfg)})


def _torch(params_np: dict, dtype=torch.float32, grad: bool = False) -> dict:
    return {k: torch.tensor(v, dtype=dtype, requires_grad=grad)
            for k, v in params_np.items()}


def _setup(t=32, d=16, e=4, k=2, cf=8.0, seed=0, f=24):
    """The reference test's ``_setup``: its config and ``init_moe_params``
    draw, with numpy-seeded tokens; returns the reference's (config,
    params, x) and the port's config, params and x."""
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f,
                          capacity_factor=cf)
    jparams = jmoe.init_moe_params(jax.random.key(seed), d, jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (t, d)).astype(np.float32)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    return (jcfg, jparams, jnp.asarray(x), _port_cfg(jcfg), params_np,
            torch.as_tensor(x))


#: The published routing (qwen3-moe's 128 experts, top-8) at narrow widths,
#: 256 tokens: capacity 4 at cf 0.25 and 20 at cf 1.25 (both drop), 512 at
#: cf 32 (none does).
PUBLISHED = {"cf0.25": 0.25, "cf1.25": 1.25, "cf32": 32.0}


def _published(cf: float, seed: int = 0):
    return _setup(t=256, d=64, e=128, k=8, cf=cf, seed=seed, f=32)


# ---------------------------------------------------------------------------
# Twins of tests/test_moe.py.
# ---------------------------------------------------------------------------
def test_capacity_matches_reference_when_no_drops():
    jcfg, jparams, jx, cfg, params_np, x = _setup(cf=16.0)
    p = _torch(params_np)
    ref, _ = moe.moe_ffn_reference(p, x, cfg)
    cap, _ = moe.moe_ffn_capacity(p, x, cfg)
    assert _rel(cap, ref) < 1e-5
    jcap, _ = jmoe.moe_ffn_capacity(jparams, jx, jcfg)
    assert _rel(cap, jcap) < TOL["float32"]


def test_gates_normalized_and_topk_unique():
    jcfg, jparams, jx, cfg, params_np, x = _setup()
    idx, gates, aux = moe.router_topk(x, _torch(params_np)["router"], cfg)
    assert idx.dtype == torch.int32 and gates.dtype == torch.float32
    assert np.allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    for row in idx.numpy():
        assert len(set(row.tolist())) == cfg.top_k
    assert float(aux) >= 0
    jidx, jgates, jaux = jmoe.router_topk(jx, jparams["router"], jcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_capacity_drops_reduce_output_norm():
    """With a tiny capacity factor some assignments drop; the capacity path
    must produce a smaller-or-equal contribution than the reference."""
    jcfg, jparams, jx, cfg, params_np, x = _setup(t=64, cf=16.0)
    tight = moe.MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                          d_ff_expert=cfg.d_ff_expert, capacity_factor=0.25)
    p = _torch(params_np)
    full, _ = moe.moe_ffn_capacity(p, x, cfg)
    dropped, _ = moe.moe_ffn_capacity(p, x, tight)
    assert float(torch.linalg.norm(dropped)) < float(torch.linalg.norm(full))
    jtight = jmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=24,
                            capacity_factor=0.25)
    jdropped, _ = jmoe.moe_ffn_capacity(jparams, jx, jtight)
    assert _rel(dropped, jdropped) < TOL["float32"]


def test_grads_flow_through_dispatch():
    """Gradients of the capacity path's squared output with respect to
    every weight: finite, nonzero for ``w_gate``, and within 1e-4 of
    ``jax.grad``'s (relative to each gradient's largest)."""
    jcfg, jparams, jx, cfg, params_np, x = _setup()
    p = _torch(params_np, grad=True)
    out, _ = moe.moe_ffn_capacity(p, x, cfg)
    (out ** 2).sum().backward()
    for key, w in p.items():
        assert bool(torch.isfinite(w.grad).all()), key
    assert float(p["w_gate"].grad.abs().max()) > 0
    jgrad = jax.grad(lambda q: jnp.sum(
        jmoe.moe_ffn_capacity(q, jx, jcfg)[0] ** 2))(jparams)
    for key, w in p.items():
        assert _rel(w.grad, jgrad[key]) < GRAD_TOL, key


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([1, 2, 4]))
def test_capacity_path_token_permutation_equivariance(seed, k):
    """Property: permuting tokens permutes outputs (no cross-token state)."""
    _, _, _, cfg, params_np, x = _setup(t=16, k=k, cf=16.0, seed=seed % 1000)
    p = _torch(params_np)
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(16))
    y1, _ = moe.moe_ffn_capacity(p, x, cfg)
    y2, _ = moe.moe_ffn_capacity(p, x[perm], cfg)
    assert _rel(y2, y1[perm]) < 1e-4


# ---------------------------------------------------------------------------
# Routing, packing and both paths at the published routing.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(PUBLISHED))
def test_router_topk_matches_reference(name):
    jcfg, jparams, jx, cfg, params_np, x = _published(PUBLISHED[name])
    idx, gates, aux = moe.router_topk(x, _torch(params_np)["router"], cfg)
    jidx, jgates, jaux = jmoe.router_topk(jx, jparams["router"], jcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.max(np.abs(gates.numpy() - np.asarray(jgates))) < 1e-6
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_pack_assignments_bit_identical(name):
    """The reference's routing fed to both packers: token, expert, slot,
    keep and gate arrays equal in value and dtype; the dropping cases
    drop."""
    jcfg, jparams, jx, cfg, params_np, x = _published(PUBLISHED[name])
    jidx, jgates, _ = jmoe.router_topk(jx, jparams["router"], jcfg)
    C = moe._capacity(x.shape[0], cfg)
    assert C == jmoe._capacity(x.shape[0], jcfg)
    expect = jmoe._pack_assignments(jx, jidx, jgates, jcfg.n_experts, C)
    got = moe._pack_assignments(x, torch.tensor(np.asarray(jidx)),
                                torch.tensor(np.asarray(jgates)),
                                cfg.n_experts, C)
    for g, e in zip(got, expect):
        e = np.asarray(e)
        assert g.numpy().dtype == e.dtype
        assert np.array_equal(g.numpy(), e)
    dropped = int((~got[3]).sum())
    assert (dropped > 0) == (name != "cf32"), dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["moe_ffn_reference", "moe_ffn_capacity"])
@pytest.mark.parametrize("name", list(PUBLISHED))
def test_moe_ffn_matches_reference(name, path, dtype):
    """Both paths on the same weights and tokens in the compute dtype (the
    reference's blocks cast every weight to it, the router included)."""
    jcfg, jparams, jx, cfg, params_np, x = _published(PUBLISHED[name])
    jdt = getattr(jnp, dtype)
    expect, jaux = getattr(jmoe, path)(
        jax.tree_util.tree_map(lambda a: a.astype(jdt), jparams),
        jx.astype(jdt), jcfg)
    got, aux = getattr(moe, path)(_torch(params_np, getattr(torch, dtype)),
                                  x.to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == expect.shape
    assert _rel(got.float(), np.asarray(expect.astype(jnp.float32))) < TOL[
        dtype]
    assert abs(float(aux) - float(jaux)) < 1e-6


def test_init_moe_params_matches_reference_layout():
    """The numpy draw has the reference's keys, shapes and LeCun scales
    (fan-in d for the router, ``w_gate`` and ``w_up``; f for ``w_down``),
    and the module holds the same layout."""
    jcfg, jparams, _, cfg, _, _ = _published(1.25)
    got = moe.init_moe_params(np.random.default_rng(0), 64, cfg)
    assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(
        np.shape, jparams)
    for key, fan in (("router", 64), ("w_gate", 64), ("w_up", 64),
                     ("w_down", 32)):
        assert got[key].dtype == np.float32
        assert abs(float(got[key].std()) * fan ** 0.5 - 1) < 0.05, key
    layer = moe.MoE(64, cfg, device="cpu")
    assert {k: tuple(layer[k].shape) for k in moe.MOE_KEYS} == {
        k: v.shape for k, v in got.items()}
    with pytest.raises(KeyError):
        layer["ln1"]


def test_module_and_dict_weights_agree():
    """The functions read an :class:`MoE` module as they read a dict."""
    _, _, _, cfg, params_np, x = _published(1.25)
    layer = moe.MoE(64, cfg, device="cpu")
    with torch.no_grad():
        for key in moe.MOE_KEYS:
            layer[key].copy_(torch.tensor(params_np[key]))
    p = _torch(params_np)
    for fn in (moe.moe_ffn_reference, moe.moe_ffn_capacity):
        a, aux_a = fn(layer, x, cfg)
        b, aux_b = fn(p, x, cfg)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
