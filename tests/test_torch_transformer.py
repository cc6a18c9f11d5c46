"""The port's serving path against the JAX reference transformer.

Weights come from the reference's ``init_params``, converted with
``np.asarray`` and loaded with ``params.load_transformer``; tokens are
seeded numpy ids.  Everything runs in f32 on the CPU, where prefill
attention takes K5's plain version.  Configs: the reference tests' tiny
``DENSE`` and ``GEMMA`` (windowed entries, soft-caps), SmolLM-135M's
full widths at 2 layers, and gemma2-2b's full widths (d 2304, 8 heads, 4
kv heads, head dim 256, d_ff 9216, both soft-caps) at 2 layers, one
(local, global) pattern group.  MoE: the reference tests' ``tiny-moe`` (4
experts, top-2, a dense residual branch), and the registry's
``qwen3-moe-smoke`` and ``arctic-smoke``: the prefill and ``forward`` route
all B * S tokens through the capacity dispatch, a decode step runs every
expert.

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

from repro.configs import arctic_480b as jarctic
from repro.configs import base as jbase
from repro.configs import gemma2_2b as jgemma2
from repro.configs import granite_3_2b as jgranite
from repro.configs import qwen3_moe_30b_a3b as jqwen3
from repro.configs import smollm_135m as jsmollm
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.models.moe import MoEConfig
from repro_torch import params
from repro_torch.configs import base, gemma2_2b, granite_3_2b, smollm_135m
from repro_torch.models import common, moe, transformer as tr
from repro_torch.models.moe import MoEConfig as TMoEConfig

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
#: gemma2-2b at its full widths and 2 layers, with two cuts so that the
#: CPU run stays small and still crosses the ring caches: the vocab 256,000
#: -> 8,192 and the local window 4,096 -> 16, so a 32-token prompt rolls
#: the ring and 8 decode steps overwrite it.
GEMMA2_2L = replace(jgemma2.make_config(), name="gemma2-2b-2l", n_layers=2,
                    vocab=8192, window_pattern=(16, None), dtype="float32")
#: The reference tests' MoE config (tests/test_transformer.py): capacity
#: factor 2 at 4 experts and top-2 makes C = T, so nothing drops.
MOE = jtr.TransformerConfig(name="tiny-moe", n_layers=2, d_model=32,
                            n_heads=4, n_kv_heads=4, d_head=8, d_ff=64,
                            vocab=128,
                            moe=MoEConfig(n_experts=4, top_k=2,
                                          d_ff_expert=32,
                                          capacity_factor=2.0,
                                          dense_residual_d_ff=32),
                            dtype="float32", q_chunk=8)
#: (config, batch, prompt length, decode steps); SmolLM at a prompt of 64,
#: gemma2 at 32 with 8 steps.
CASES = {"tiny-dense": (DENSE, 2, 16, 4), "tiny-gemma": (GEMMA, 2, 16, 4),
         "smollm-135m-2l": (SMOLLM_2L, 2, 64, 4),
         "gemma2-2b-2l": (GEMMA2_2L, 2, 32, 8),
         "tiny-moe": (MOE, 2, 16, 4),
         "qwen3-moe-smoke": (jqwen3.make_smoke_config(), 2, 16, 4),
         "arctic-smoke": (jarctic.make_smoke_config(), 2, 16, 4)}
TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _port_cfg(jcfg) -> tr.TransformerConfig:
    names = {f.name for f in fields(tr.TransformerConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in fields(jcfg)
          if f.name in names}
    if jcfg.moe is not None:
        kw["moe"] = TMoEConfig(**{f.name: getattr(jcfg.moe, f.name)
                                  for f in fields(jcfg.moe)})
    return tr.TransformerConfig(**kw)


@cache
def _build(name):
    """Reference params, the port's module holding them, and tokens (read
    only: no test changes them)."""
    jcfg, b, s, steps = CASES[name]
    jparams = jtr.init_params(jcfg, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = _port_cfg(jcfg)
    model = params.load_transformer(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab,
                                               (b, s + steps))
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
    """Prefill logits and every cache entry, then 4 decode steps (8 for
    gemma2, through its ring) from the prefilled cache, each step's
    logits."""
    jcfg, jparams, cfg, model, tokens = _build(name)
    s, steps = CASES[name][2:]
    jpre = jax.jit(jtr.make_prefill_step(jcfg, max_seq=s + steps))
    jserve = jax.jit(jtr.make_serve_step(jcfg, s + steps))
    jlg, jcache = jpre(jparams, jnp.asarray(tokens[:, :s]))
    lg, cache = tr.make_prefill_step(cfg, max_seq=s + steps)(
        model, torch.as_tensor(tokens[:, :s]))
    assert _rel(lg, jlg) < TOL
    assert set(cache) == set(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert _rel(cache[key], jcache[key]) < TOL, key
    serve = tr.make_serve_step(cfg, s + steps)
    for i in range(s, s + steps):
        jlg, jcache = jserve(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
        lg, cache = serve(model, cache, torch.as_tensor(tokens[:, i:i + 1]),
                          i)
        assert _rel(lg, jlg) < TOL, i


@pytest.mark.parametrize("name", list(CASES))
def test_forward_hidden_matches_reference(name):
    """The final normed hidden state and the balance loss summed over the
    layers (0 for a dense config) against the reference's
    ``forward_hidden``, and the loss against its ``forward``'s second
    output."""
    jcfg, jparams, cfg, model, tokens = _build(name)
    s = CASES[name][2]
    t = jnp.asarray(tokens[:, :s])
    hidden, aux = tr.forward_hidden(cfg, model, torch.as_tensor(tokens[:, :s]))
    jhidden, jaux = jax.jit(lambda p, t: jtr.forward_hidden(jcfg, p, t))(
        jparams, t)
    _, jaux_fwd = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(jparams, t)
    assert hidden.shape == jhidden.shape and aux.dtype == torch.float32
    assert _rel(hidden, jhidden) < TOL
    assert abs(float(aux) - float(jaux)) < 1e-6
    assert abs(float(aux) - float(jaux_fwd)) < 1e-6
    assert (float(aux) > 0) == (jcfg.moe is not None)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-gemma", "tiny-moe"])
def test_decode_matches_forward(name):
    """Decode from an empty cache reproduces the forward's last logits (the
    reference's test_decode_matches_forward).  For tiny-moe nothing drops
    in the forward (C = T), so its capacity dispatch and decode's
    all-expert path compute the same function."""
    _, _, cfg, model, tokens = _build(name)
    b, s = CASES[name][1:3]
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
    b, s = CASES["tiny-gemma"][1:3]
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


def test_moe_transformer_params_round_trip():
    """The MoE layout: ``blocks[i]["moe"]`` stacks of the router and the 3-D
    expert weights, and the dense residual branch, with the same keys and
    shapes as ``init_params``; layer g * P + i holds slice g of each."""
    cfg = _port_cfg(MOE)
    p = params.transformer_params(cfg, seed=5)
    jp = jtr.init_params(MOE, jax.random.key(0))
    assert (jax.tree_util.tree_map(np.shape, p)
            == jax.tree_util.tree_map(np.shape, jp))
    assert p["blocks"][0]["moe"]["w_gate"].shape == (2, 4, 32, 32)
    model = params.load_transformer(p, cfg, device="cpu")
    assert not any(hasattr(model.layers[0], k) for k in ("w_gate", "w_up",
                                                          "w_down"))
    assert tr.layer_keys(cfg) == tr.LAYER_KEYS[:6] + tr.RESIDUAL_KEYS
    for n, layer in enumerate(model.layers):
        g, i = divmod(n, len(cfg.window_pattern))
        block = p["blocks"][i]
        for key in tr.layer_keys(cfg):
            assert np.array_equal(getattr(layer, key).numpy(),
                                  block[key][g]), (n, key)
        for key in moe.MOE_KEYS:
            assert np.array_equal(layer.moe[key].numpy(),
                                  block["moe"][key][g]), (n, key)
    scaled = np.concatenate([p["blocks"][0]["moe"][k].ravel() * 32 ** 0.5
                             for k in moe.MOE_KEYS])
    assert abs(float(scaled.std()) - 1) < 0.05


def test_moe_seeded_draw_fills_expert_weights():
    """``draw_transformer`` draws the 3-D expert weights too, each with
    std ``fan_in ** -0.5`` where ``fan_in`` is the second-to-last dimension:
    d for ``w_gate`` / ``w_up`` (E, d, f), f for ``w_down`` (E, f, d)."""
    cfg = replace(_port_cfg(jqwen3.make_smoke_config()), d_model=64,
                  moe=TMoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                                 dense_residual_d_ff=96))
    model = params.draw_transformer(cfg, seed=3, device="cpu")
    again = params.draw_transformer(cfg, seed=3, device="cpu")
    layer = model.layers[0]
    assert (tuple(layer.moe.w_gate.shape), tuple(layer.moe.w_down.shape)) == (
        (8, 64, 48), (8, 48, 64))
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if p.dim() == 1:
            continue
        std = 0.02 if name == "embed" else p.shape[-2] ** -0.5
        assert abs(float(p.std()) / std - 1) < 0.1, name
    assert abs(float(layer.moe.w_down.std()) * 48 ** 0.5 - 1) < 0.1
    assert abs(float(layer.res_down.std()) * 96 ** 0.5 - 1) < 0.1
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


def test_load_refuses_wrong_shapes():
    cfg = _port_cfg(DENSE)
    p = params.transformer_params(cfg, 0)
    p["blocks"][0]["wq"] = p["blocks"][0]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params.load_transformer(p, cfg, device="cpu")


def test_moe_config_raises():
    """An MoE config constructs and counts its parameters as the
    reference's does, builds its model and loads the reference's
    ``init_params``; a dense layout loaded into it raises, and so do a
    load and a build that ask for no device when there is no card."""
    jmoe = jtr.TransformerConfig(
        name="tiny-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                      dense_residual_d_ff=16),
        dtype="float32")
    cfg = _port_cfg(jmoe)
    assert cfg.param_count() == jmoe.param_count()
    assert cfg.active_param_count() == jmoe.active_param_count()
    model = tr.Transformer(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    jp = jax.tree_util.tree_map(np.asarray, jtr.init_params(
        jmoe, jax.random.key(0)))
    model = params.load_transformer(jp, cfg, device="cpu")
    assert np.array_equal(model.layers[1].moe.w_down.numpy(),
                          jp["blocks"][0]["moe"]["w_down"][1])
    assert np.array_equal(model.layers[0].res_gate.numpy(),
                          jp["blocks"][0]["res_gate"][0])
    with pytest.raises(ValueError, match="moe"):
        params.load_transformer(params.transformer_params(
            replace(cfg, moe=None), 0), cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            params.load_transformer(jp, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tr.Transformer(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            moe.MoE(cfg.d_model, cfg.moe)


@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_smollm_configs_match_reference(make):
    cfg, jcfg = getattr(smollm_135m, make)(), getattr(jsmollm, make)()
    for f in fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.compute_dtype == (torch.bfloat16 if make == "make_config"
                                 else torch.float32)


@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
@pytest.mark.parametrize("port,ref", [(gemma2_2b, jgemma2),
                                      (granite_3_2b, jgranite)],
                         ids=["gemma2-2b", "granite-3-2b"])
def test_lm_configs_match_reference(port, ref, make):
    """The twin of test_smollm_configs_match_reference for gemma2-2b and
    granite-3-2b: every field (the training knobs ``remat`` and
    ``q_chunk`` among them), and the parameter counts."""
    cfg, jcfg = getattr(port, make)(), getattr(ref, make)()
    for f in fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert {f.name for f in fields(cfg)} == {f.name for f in fields(jcfg)}
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_gemma2_seeded_draw_on_the_cpu():
    """``draw_transformer`` fills every weight from a seeded generator with
    the reference's initializers, and repeats for the same seed."""
    cfg = replace(gemma2_2b.make_config(), n_layers=2, d_model=64, d_ff=96,
                  vocab=512, dtype="float32")
    model = params.draw_transformer(cfg, seed=3, device="cpu")
    again = params.draw_transformer(cfg, seed=3, device="cpu")
    other = params.draw_transformer(cfg, seed=4, device="cpu")
    for (name, p), q, r in zip(model.named_parameters(), again.parameters(),
                               other.parameters()):
        assert torch.equal(p, q), name
        if p.dim() == 1:
            assert not p.any(), name
            continue
        assert not torch.equal(p, r), name
        std = 0.02 if name == "embed" else p.shape[0] ** -0.5
        assert abs(float(p.std()) / std - 1) < 0.1, name
        assert abs(float(p.mean())) < 4 * std / p.numel() ** 0.5, name
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.embed.dtype == torch.float32 and not model.embed.requires_grad


def test_gemma2_published_config_counts():
    """gemma2-2b as the registry publishes it: 2,614 M parameters, 5.23 GB
    of bf16 weights."""
    cfg = gemma2_2b.make_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (26, 2304, 8, 4, 256, 9216,
                                                 256000)
    assert cfg.window_pattern == (4096, None) and cfg.n_groups == 13
    assert cfg.param_count() == jgemma2.make_config().param_count()
    assert round(cfg.param_count() / 1e6) == 2614
    assert round(2 * cfg.param_count() / 1e9, 2) == 5.23


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


@pytest.mark.gpu
def test_moe_prefill_on_the_card_matches_the_cpu(cuda_device):
    """tiny-moe's widths with a head dim K5 takes (16): the prefill's
    logits and caches, card (K5, the capacity dispatch) against the CPU."""
    from repro_torch import backend
    from repro_torch.kernels import ops

    backend.full_fp32()
    cfg = replace(_port_cfg(MOE), d_head=16)
    p = params.transformer_params(cfg, 0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    prefill = tr.make_prefill_step(cfg, max_seq=136)
    ops.reset_launches()
    lg, cache = prefill(params.load_transformer(p, cfg, device=cuda_device),
                        tokens.to(cuda_device))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    expect, expect_cache = prefill(
        params.load_transformer(p, cfg, device="cpu"), tokens)
    assert _rel(lg.cpu(), expect) < TOL
    for key in cache:
        assert _rel(cache[key].cpu(), expect_cache[key]) < TOL, key
