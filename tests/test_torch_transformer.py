"""The port's SmolLM serving path against the JAX reference transformer.

Weights come from the reference's ``init_params``, converted with
``np.asarray`` and loaded with ``params.load_transformer``; tokens are
seeded numpy ids.  Everything runs in f32 on the CPU, where prefill
attention takes K5's plain version.  Configs: the reference tests' tiny
``DENSE`` and ``GEMMA`` (windowed entries, soft-caps) and SmolLM-135M's
full widths at 2 layers.

Tolerance: 1e-4 relative to the largest logit, the reference's own
(``tests/test_transformer.py``): fp32 products, exponentials and norms in
another order across the layers.
"""

from dataclasses import fields, replace
from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import smollm_135m as jsmollm
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.models.moe import MoEConfig
from repro_torch import params
from repro_torch.configs import base, smollm_135m
from repro_torch.models import common, transformer as tr

DENSE = jtr.TransformerConfig(name="tiny-dense", n_layers=4, d_model=32,
                              n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
                              vocab=128, dtype="float32", q_chunk=8)
GEMMA = jtr.TransformerConfig(name="tiny-gemma", n_layers=4, d_model=32,
                              n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
                              vocab=128, window_pattern=(8, None),
                              attn_softcap=50.0, final_softcap=30.0,
                              dtype="float32", q_chunk=8)
SMOLLM_2L = replace(jsmollm.make_config(), name="smollm-135m-2l", n_layers=2,
                    dtype="float32")
#: (config, batch, prompt length); SmolLM at a prompt of 64.
CASES = {"tiny-dense": (DENSE, 2, 16), "tiny-gemma": (GEMMA, 2, 16),
         "smollm-135m-2l": (SMOLLM_2L, 2, 64)}
TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _port_cfg(jcfg) -> tr.TransformerConfig:
    names = {f.name for f in fields(tr.TransformerConfig)}
    return tr.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                   for f in fields(jcfg) if f.name in names})


@cache
def _build(name):
    """Reference params, the port's module holding them, and tokens (read
    only: no test changes them)."""
    jcfg, b, s = CASES[name]
    jparams = jtr.init_params(jcfg, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = _port_cfg(jcfg)
    model = params.load_transformer(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (b, s + 4))
    return jcfg, jparams, cfg, model, tokens


# ---------------------------------------------------------------------------
# Port vs reference, same weights and tokens.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference(name):
    jcfg, jparams, cfg, model, tokens = _build(name)
    s = CASES[name][2]
    expect, _ = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(
        jparams, jnp.asarray(tokens[:, :s]))
    got = tr.forward(cfg, model, torch.as_tensor(tokens[:, :s]))
    assert got.shape == expect.shape
    assert _rel(got, expect) < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_continuation_match_reference(name):
    """Prefill logits and every cache entry, then 4 decode steps from the
    prefilled cache, each step's logits."""
    jcfg, jparams, cfg, model, tokens = _build(name)
    s = CASES[name][2]
    jpre = jax.jit(jtr.make_prefill_step(jcfg, max_seq=s + 4))
    jserve = jax.jit(jtr.make_serve_step(jcfg, s + 4))
    jlg, jcache = jpre(jparams, jnp.asarray(tokens[:, :s]))
    lg, cache = tr.make_prefill_step(cfg, max_seq=s + 4)(
        model, torch.as_tensor(tokens[:, :s]))
    assert _rel(lg, jlg) < TOL
    assert set(cache) == set(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert _rel(cache[key], jcache[key]) < TOL, key
    serve = tr.make_serve_step(cfg, s + 4)
    for i in range(s, s + 4):
        jlg, jcache = jserve(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
        lg, cache = serve(model, cache, torch.as_tensor(tokens[:, i:i + 1]),
                          i)
        assert _rel(lg, jlg) < TOL, i


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-gemma"])
def test_decode_matches_forward(name):
    """Decode from an empty cache reproduces the forward's last logits (the
    reference's test_decode_matches_forward)."""
    _, _, cfg, model, tokens = _build(name)
    b, s = CASES[name][1:]
    t = torch.as_tensor(tokens[:, :s])
    logits = tr.forward(cfg, model, t)
    cache = tr.init_cache(cfg, b, s, device="cpu")
    serve = tr.make_serve_step(cfg, s)
    for i in range(s):
        lg, cache = serve(model, cache, t[:, i:i + 1], i)
    assert _rel(lg, logits[:, -1]) < TOL


def test_prefill_matches_decode_and_continues():
    """The reference's test of the same name, on the port alone: the ring
    caches of the windowed entries continue decode as the full caches do."""
    _, _, cfg, model, tokens = _build("tiny-gemma")
    b, s = CASES["tiny-gemma"][1:]
    t = torch.as_tensor(tokens)
    serve = tr.make_serve_step(cfg, s + 4)
    cache_d = tr.init_cache(cfg, b, s + 4, device="cpu")
    for i in range(s):
        lg_d, cache_d = serve(model, cache_d, t[:, i:i + 1], i)
    lg_p, cache_p = tr.make_prefill_step(cfg, max_seq=s + 4)(model, t[:, :s])
    assert _rel(lg_p, lg_d) < TOL
    for i in range(s, s + 4):
        lg_p, cache_p = serve(model, cache_p, t[:, i:i + 1], i)
        lg_d, cache_d = serve(model, cache_d, t[:, i:i + 1], i)
    assert _rel(lg_p, lg_d) < TOL


def test_window_pattern_restricts_attention():
    """A token outside every window does not reach the last position's
    logits: 2 layers of window 4 see 7 tokens back, not 16."""
    cfg = tr.TransformerConfig(name="w", n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=4, d_head=8, d_ff=64, vocab=64,
                               window_pattern=(4,), dtype="float32")
    model = params.load_transformer(params.transformer_params(cfg, 0), cfg,
                                    device="cpu")
    t1 = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (1, 16)))
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 1) % 64
    l1, l2 = tr.forward(cfg, model, t1), tr.forward(cfg, model, t2)
    assert _rel(l1[:, -1], l2[:, -1]) < 1e-6
    assert _rel(l1[:, 0], l2[:, 0]) > 1e-3


@pytest.mark.parametrize("batch,max_seq", [(2, 20), (3, 5)])
@pytest.mark.parametrize("name", ["tiny-dense", "tiny-gemma"])
def test_cache_shapes_match_reference(name, batch, max_seq):
    jcfg, _, cfg, _, _ = _build(name)
    assert tr.cache_shapes(cfg, batch, max_seq) == jtr.cache_shapes(
        jcfg, batch, max_seq)
    cache = tr.init_cache(cfg, batch, max_seq, device="cpu")
    jcache = jtr.init_cache(jcfg, batch, max_seq)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    assert all(not v.any() for v in cache.values())


def test_common_blocks_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)[None]
    tx, tscale, tpos = (torch.as_tensor(a) for a in (x, scale, pos))
    assert _rel(common.rms_norm(tx, tscale),
                jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))) < 1e-6
    freqs = jcommon.rope_freqs(16, theta=1e4)
    assert _rel(common.rope_freqs(16, theta=1e4), freqs) < 1e-6
    assert _rel(common.apply_rope(tx, tpos, common.rope_freqs(16)),
                jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   jcommon.rope_freqs(16))) < 1e-5
    assert _rel(common.softcap(tx * 100, 30.0),
                jcommon.softcap(jnp.asarray(x) * 100, 30.0)) < 1e-6


# ---------------------------------------------------------------------------
# Parameters and configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_param_count_matches_loaded_module(name):
    jcfg, jparams, cfg, model, _ = _build(name)
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == jcfg.param_count()
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(jparams))


def test_transformer_params_round_trip():
    """Seeded numpy params in the reference layout (same keys and shapes as
    ``init_params``) load so that layer g * P + i holds block i's slice g."""
    cfg = _port_cfg(replace(GEMMA, tie_embeddings=False))
    p = params.transformer_params(cfg, seed=5)
    jp = jtr.init_params(replace(GEMMA, tie_embeddings=False),
                         jax.random.key(0))
    assert (jax.tree_util.tree_map(np.shape, p)
            == jax.tree_util.tree_map(np.shape, jp))
    model = params.load_transformer(p, cfg, device="cpu")
    P = len(cfg.window_pattern)
    for n, layer in enumerate(model.layers):
        g, i = divmod(n, P)
        assert layer.window == cfg.window_pattern[i]
        for key in tr.LAYER_KEYS:
            assert np.array_equal(getattr(layer, key).numpy(),
                                  p["blocks"][i][key][g]), (n, key)
    assert np.array_equal(model.embed.numpy(), p["embed"])
    assert np.array_equal(model.unembed.numpy(), p["unembed"])
    same = params.transformer_params(cfg, seed=5)
    assert np.array_equal(same["blocks"][1]["wq"], p["blocks"][1]["wq"])
    assert model.embed.dtype == torch.float32 and not model.embed.requires_grad


def test_load_refuses_wrong_shapes():
    cfg = _port_cfg(DENSE)
    p = params.transformer_params(cfg, 0)
    p["blocks"][0]["wq"] = p["blocks"][0]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params.load_transformer(p, cfg, device="cpu")


def test_moe_config_raises():
    jmoe = jtr.TransformerConfig(
        name="tiny-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
        dtype="float32")
    with pytest.raises(NotImplementedError, match="MoE"):
        _port_cfg(jmoe)


@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_smollm_configs_match_reference(make):
    cfg, jcfg = getattr(smollm_135m, make)(), getattr(jsmollm, make)()
    for f in fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.compute_dtype == (torch.bfloat16 if make == "make_config"
                                 else torch.float32)


def test_lm_shapes_match_reference():
    assert base.LM_SHAPES.keys() == jbase.LM_SHAPES.keys()
    for name, spec in base.LM_SHAPES.items():
        ref_spec = jbase.LM_SHAPES[name]
        assert (spec.name, spec.kind, dict(spec.params)) == (
            ref_spec.name, ref_spec.kind, dict(ref_spec.params))


def test_smoke_config_serves_on_the_cpu():
    cfg = smollm_135m.make_smoke_config()
    model = params.load_transformer(params.transformer_params(cfg, 0), cfg,
                                    device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                               (2, 32)))
    lg, cache = tr.make_prefill_step(cfg, max_seq=40)(model, tokens)
    nxt = lg.argmax(-1, keepdim=True)
    lg2, _ = tr.make_serve_step(cfg, 40)(model, cache, nxt, 32)
    assert lg2.shape == (2, 256) and bool(torch.isfinite(lg2).all())


def test_entry_points_need_a_card_unless_cpu_is_asked():
    cfg = smollm_135m.make_smoke_config()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        params.load_transformer(params.transformer_params(cfg, 0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# On the card: the serving path through K5 against the CPU.
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_prefill_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch import backend
    from repro_torch.kernels import ops

    backend.full_fp32()
    cfg = replace(smollm_135m.make_config(), n_layers=2, dtype="float32")
    p = params.transformer_params(cfg, 0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    prefill = tr.make_prefill_step(cfg)
    ops.reset_launches()
    lg, _ = prefill(params.load_transformer(p, cfg, device=cuda_device),
                    tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    expect, _ = prefill(params.load_transformer(p, cfg, device="cpu"), tokens)
    assert _rel(lg.cpu(), expect) < TOL
