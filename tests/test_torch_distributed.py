"""The port's distributed substrate against the reference.

The gloo battery twins ``tests/distributed_checks.py``: each test computes
the reference's single-device output with JAX here, pickles it beside the
inputs (the port's configs, the reference's weights as numpy), and runs
``tests/torch_distributed_checks.py`` in a subprocess, which starts 8 gloo
ranks on a (2, 4) mesh (one CPU thread a rank) and holds the port's
sharded paths to it: 2e-4 on every output, as the reference's battery,
gradients against single-device autograd at 1e-4, and the collective
ledger equal to the traffic models exactly.

The in-process tests hold the spec trees, the edge partitions, the byte
models and the decode partials to the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tpu_model as ref_tpu
from repro.distributed import ring as ref_ring
from repro.distributed import sharding as ref_sharding
from repro.models import attention as ref_attn
from repro.models import dlrm as ref_dlrm
from repro.models import transformer as ref_tf
from repro.models.moe import MoEConfig as RefMoEConfig
from repro_torch.core import comm_model
from repro_torch.distributed import ring, sharding
from repro_torch.launch.mesh import AbstractMesh, PRODUCTION_MESHES
from repro_torch.models import attention, dlrm, transformer as tr
from repro_torch.models.moe import MoEConfig

ROOT = Path(__file__).resolve().parents[1]
CHECKS = Path(__file__).parent / "torch_distributed_checks.py"
#: Each check's subprocess: 8 ranks importing torch, then the check.
CHECK_TIMEOUT = 240


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(ref_cfg) -> tr.TransformerConfig:
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(fields["moe"]))
    return tr.TransformerConfig(**fields)


def _run(check: str, data: dict, tmp_path) -> str:
    path = tmp_path / f"{check}.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(CHECKS), check, str(path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=CHECK_TIMEOUT)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    assert f"CHECK {check} PASSED on 8 ranks" in proc.stdout
    return proc.stdout


# ---------------------------------------------------------------------------
# The gloo battery
# ---------------------------------------------------------------------------

MOE_CFG = ref_tf.TransformerConfig(
    name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_head=8,
    d_ff=64, vocab=128,
    moe=RefMoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                     capacity_factor=8.0),
    dtype="float32", q_chunk=8)
CTX_CFG = ref_tf.TransformerConfig(
    name="c", n_layers=2, d_model=24, n_heads=3, n_kv_heads=3, d_head=8,
    d_ff=64, vocab=128, dtype="float32", q_chunk=4)
DECODE_CFG = ref_tf.TransformerConfig(
    name="d", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=128, window_pattern=(8, None), dtype="float32",
    q_chunk=8)


def _forward_case(cfg, seed_p: int, seed_t: int, shape) -> dict:
    params = ref_tf.init_params(cfg, jax.random.key(seed_p))
    tokens = jax.random.randint(jax.random.key(seed_t), shape, 0, cfg.vocab)
    ref, _ = jax.jit(lambda p, t: ref_tf.forward(cfg, p, t))(params, tokens)
    return {"cfg": _port_cfg(cfg), "params": _np(params),
            "tokens": np.asarray(tokens, np.int64),
            "expect": np.asarray(ref)}


def test_moe_expert_parallel_with_tp_heads(tmp_path):
    data = _forward_case(MOE_CFG, 0, 1, (4, 16))
    data["moe_x"] = np.random.default_rng(0).standard_normal(
        (8, MOE_CFG.d_model)).astype(np.float32)
    out = _run("moe_ep", data, tmp_path)
    assert "moe_dispatch_sync" in out


def test_context_parallel_three_heads_on_tp4(tmp_path):
    _run("ctx", _forward_case(CTX_CFG, 2, 3, (2, 16)), tmp_path)


def test_sharded_decode_and_prefill(tmp_path):
    cfg = DECODE_CFG
    params = ref_tf.init_params(cfg, jax.random.key(4))
    S = 16
    tokens = jax.random.randint(jax.random.key(5), (2, S), 0, cfg.vocab)
    serve = jax.jit(ref_tf.make_serve_step(cfg, S))
    cache = ref_tf.init_cache(cfg, 2, S)
    expect = []
    for i in range(S):
        lg, cache = serve(params, cache, tokens[:, i:i + 1],
                          jnp.asarray(i, jnp.int32))
        expect.append(np.asarray(lg))
    # The reference battery's own check: its prefill equals its decode.
    lp, _ = jax.jit(ref_tf.make_prefill_step(cfg))(params, tokens)
    assert np.max(np.abs(np.asarray(lp) - expect[-1])) < 2e-4 * np.max(
        np.abs(expect[-1]))
    _run("decode", {"cfg": _port_cfg(cfg), "params": _np(params),
                    "tokens": np.asarray(tokens, np.int64),
                    "expect": expect}, tmp_path)


def test_ring_and_allgather_spmm(tmp_path):
    rng = np.random.default_rng(0)
    N, E, F = 64, 300, 12
    snd = rng.integers(0, N, E)
    rcv = rng.integers(0, N, E)
    wgt = rng.random(E).astype(np.float32)
    h = rng.standard_normal((N, F)).astype(np.float32)
    ref = np.zeros((N, F), np.float32)
    np.add.at(ref, rcv, h[snd] * wgt[:, None])
    out = _run("ring", {"h": h, "snd": snd, "rcv": rcv, "wgt": wgt,
                        "n_nodes": N, "expect": ref}, tmp_path)
    assert out.count("ratio=1.000") == 2


def test_gpipe_and_its_gradient(tmp_path):
    rng = np.random.default_rng(0)
    S, M, B, D = 4, 6, 3, 8
    ws = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    bs = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ ws[s] + bs[s])
    _run("gpipe", {"ws": ws, "bs": bs, "x": x, "expect": np.asarray(ref)},
         tmp_path)


def _dlrm_case(vocab_sizes) -> dict:
    cfg = ref_dlrm.DLRMConfig(name="t", embed_dim=16,
                              vocab_sizes=vocab_sizes, bot_mlp=(32, 16),
                              top_mlp=(64, 1))
    params = ref_dlrm.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    B = 16
    sparse = np.stack([rng.integers(0, v, (B, 1)) for v in vocab_sizes], 1)
    batch = {"dense": rng.standard_normal((B, 13)).astype(np.float32),
             "sparse": sparse.astype(np.int32)}
    ref = jax.jit(lambda p, b: ref_dlrm.forward(cfg, p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port_cfg = dlrm.DLRMConfig(name="t", embed_dim=16,
                               vocab_sizes=vocab_sizes, bot_mlp=(32, 16),
                               top_mlp=(64, 1))
    return {"cfg": port_cfg, "params": _np(params), "batch": batch,
            "expect": np.asarray(ref)}


def test_dlrm_vocab_parallel(tmp_path):
    # The reference battery's tables (over all 8 ranks, and 100 rows over
    # tp alone), then one that shards nowhere (13 rows).
    cases = [_dlrm_case((64, 100, 32, 48) + (16,) * 22),
             _dlrm_case((64, 100, 13, 48) + (16,) * 22)]
    out = _run("dlrm", {"cases": cases}, tmp_path)
    assert "shards [1, 4, 8]" in out and "shards [4, 8]" in out


def test_dlrm_seeded_draw_agrees_across_ranks(tmp_path):
    # Drawn on the ranks (no numpy tree): replicated (13 rows), tp-only
    # (100 rows) and fully sharded tables, each checked across the 8 ranks.
    cfg = dlrm.DLRMConfig(name="t", embed_dim=16,
                          vocab_sizes=(64, 100, 13, 48) + (16,) * 22,
                          bot_mlp=(32, 16), top_mlp=(64, 1))
    out = _run("dlrm_draw", {"cfg": cfg}, tmp_path)
    assert "(1, 1), (4, 1), (8, 24)" in out


def test_ledger_equals_traffic_models(tmp_path):
    out = _run("traffic", {}, tmp_path)
    assert out.count("ratio=1.000") == 2


# ---------------------------------------------------------------------------
# In process: spec trees, partitions, byte models, decode partials
# ---------------------------------------------------------------------------

class _StandIn:
    """What the reference's policy reads of a mesh: ``shape`` by name and
    ``axis_names`` (the pytest process has one JAX device)."""

    def __init__(self, mesh: AbstractMesh):
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names


MESHES = {"2x4": AbstractMesh(("data", "model"), (2, 4)),
          "16x16": PRODUCTION_MESHES["single_pod"],
          "pod2x16x16": PRODUCTION_MESHES["multi_pod"]}
LM_ARCHS = ("smollm-135m", "granite-3-2b", "gemma2-2b", "qwen3-moe-30b-a3b",
            "arctic-480b")


def _policies(mesh_name: str):
    mesh = MESHES[mesh_name]
    return (sharding.make_policy(mesh),
            ref_sharding.make_policy(_StandIn(mesh)))


def _pairs(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _pairs(a, b, f"{path}[{i}]")
    else:
        yield path, port, ref


def _same_specs(port, ref) -> int:
    n = 0
    for path, a, b in _pairs(port, ref):
        assert a == tuple(b), (path, a, b)
        n += 1
    return n


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_policy_sizes_equal_reference(mesh_name):
    port, ref = _policies(mesh_name)
    assert (port.dp_axes, port.tp_axis, port.dp, port.tp, port.n_devices,
            port.dp_spec) == (ref.dp_axes, ref.tp_axis, ref.dp, ref.tp,
                              ref.n_devices, ref.dp_spec)
    assert port.act_spec() == tuple(ref.act_spec())
    assert port.batch_spec() == tuple(ref.batch_spec())
    off = sharding.ShardingPolicy(MESHES[mesh_name], seq_parallel_residual=False,
                                  dp_axes=port.dp_axes)
    ref_off = ref_sharding.ShardingPolicy(_StandIn(MESHES[mesh_name]),
                                          seq_parallel_residual=False,
                                          dp_axes=ref.dp_axes)
    assert off.act_spec() == tuple(ref_off.act_spec())


@pytest.mark.parametrize("mesh_name", ["2x4", "16x16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_transformer_param_pspecs_equal_reference(arch, mesh_name):
    from repro.configs import get_arch as ref_arch
    from repro_torch.configs import get_arch
    port, ref = _policies(mesh_name)
    cfg, ref_cfg = get_arch(arch).make_config(), ref_arch(arch).make_config()
    assert _same_specs(tr.param_pspecs(cfg, port),
                       ref_tf.param_pspecs(ref_cfg, ref)) > 8


@pytest.mark.parametrize("mesh_name", ["2x4", "16x16"])
def test_dlrm_param_pspecs_equal_reference(mesh_name):
    from repro.configs import get_arch as ref_arch
    from repro_torch.configs import get_arch
    port, ref = _policies(mesh_name)
    cfg = get_arch("dlrm-mlperf").make_config()
    ref_cfg = ref_arch("dlrm-mlperf").make_config()
    assert _same_specs(dlrm.param_pspecs(cfg, port),
                       ref_dlrm.param_pspecs(ref_cfg, ref)) == 26 + 16


@pytest.mark.parametrize("decode", [((("model",), ("data",))),
                                    ((("data", "model"), ())),
                                    (((), ("data",)))])
@pytest.mark.parametrize("mesh_name", ["2x4", "16x16"])
def test_cache_pspecs_equal_reference(decode, mesh_name):
    port, ref = _policies(mesh_name)
    cfg = _port_cfg(DECODE_CFG)
    seq, bat = decode
    got = tr.cache_pspecs(cfg, port, tr.DecodePolicy(seq, bat))
    want = ref_tf.cache_pspecs(DECODE_CFG, ref, ref_tf.DecodePolicy(seq, bat))
    assert _same_specs(got, want) == 4


@pytest.mark.parametrize("mesh_name", ["2x4", "16x16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_fsdp_specs_equal_reference(arch, mesh_name):
    from repro.configs import get_arch as ref_arch
    from repro_torch.configs import get_arch
    port, ref = _policies(mesh_name)
    cfg, ref_cfg = get_arch(arch).make_config(), ref_arch(arch).make_config()
    abstract = ref_tf.abstract_params(ref_cfg)
    meta = jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
        abstract)
    got = sharding.fsdp_specs(meta, tr.param_pspecs(cfg, port), port)
    want = ref_sharding.fsdp_specs(abstract, ref_tf.param_pspecs(ref_cfg,
                                                                 ref), ref)
    assert _same_specs(got, want) > 8


def _graph(seed: int, n_nodes: int, n_edges: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_nodes, n_edges), rng.integers(0, n_nodes,
                                                            n_edges),
            rng.random(n_edges).astype(np.float32))


@pytest.mark.parametrize("n_nodes,n_edges,n_shards", [
    (64, 300, 8), (64, 0, 4), (60, 1000, 3), (48, 7, 1), (96, 2000, 16)])
def test_partitions_bit_identical(n_nodes, n_edges, n_shards):
    snd, rcv, wgt = _graph(n_nodes + n_edges, n_nodes, n_edges)
    for port_fn, ref_fn in ((ring.partition_edges_ring,
                             ref_ring.partition_edges_ring),
                            (ring.partition_edges_gather,
                             ref_ring.partition_edges_gather)):
        got = port_fn(snd, rcv, wgt, n_nodes, n_shards)
        want = ref_fn(snd, rcv, wgt, n_nodes, n_shards)
        for key in ("senders", "receivers", "weights"):
            a, b = getattr(got, key), getattr(want, key)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key
        assert got.n_local == want.n_local
        assert got.pad_ratio == want.pad_ratio


def test_partition_of_a_power_law_graph_bit_identical():
    """Skewed blocks: most edges land in a few (dst, src) pairs."""
    from repro_torch.data.synthetic import power_law_graph
    g = power_law_graph(3, n_nodes=4096, n_edges=20000, d_feat=1)
    snd, rcv = np.asarray(g.senders), np.asarray(g.receivers)
    wgt = np.random.default_rng(1).random(snd.shape[0])
    for n_shards in (4, 8):
        got = ring.partition_edges_ring(snd, rcv, wgt, 4096, n_shards)
        want = ref_ring.partition_edges_ring(snd, rcv, wgt, 4096, n_shards)
        assert np.array_equal(got.senders, want.senders)
        assert np.array_equal(got.receivers, want.receivers)
        assert np.array_equal(got.weights, want.weights)
        assert got.pad_ratio == want.pad_ratio


COMM_CALLS = [
    ("allgather_bytes", (1e6, 8)), ("allgather_bytes", (123.0, 1)),
    ("reduce_scatter_bytes", (4096.0, 4)), ("allreduce_bytes", (7.5e8, 16)),
    ("allreduce_bytes", (3.0, 1)), ("all_to_all_bytes", (1 << 20, 3)),
    ("collective_permute_bytes", (2.5e6,)),
    ("dp_gradient_sync", (1.35e8 * 4, 16)),
    ("dp_gradient_sync", (1e9, 256), {"compressed_ratio": 0.25}),
    ("tp_activation_sync", (8 * 4096 * 576 * 2, 30, 16)),
    ("tp_activation_sync", (1e6, 2, 4), {"seq_sharded": False}),
    ("moe_dispatch_sync", (65536, 2048, 8, 16, 48)),
    ("moe_dispatch_sync", (1, 7, 1, 1, 1), {"dtype_bytes": 4}),
    ("spmm_feature_allgather", (2449029, 100, 4)),
    ("spmm_feature_allgather", (2708, 1433, 8), {"layers": 2,
                                                 "dtype_bytes": 2}),
    ("ring_spmm_traffic", (2449032, 100, 4)),
    ("ring_spmm_traffic", (64, 16, 1)),
    ("dlrm_embedding_exchange", (2048, 26, 128, 16)),
    ("dlrm_embedding_exchange", (512, 26, 128, 4), {"with_backward": False}),
]


@pytest.mark.parametrize("call", COMM_CALLS, ids=lambda c: c[0])
def test_comm_model_bit_identical(call):
    name, args = call[0], call[1]
    kw = call[2] if len(call) > 2 else {}
    got = getattr(comm_model, name)(*args, **kw)
    want = getattr(ref_tpu, name)(*args, **kw)
    if isinstance(want, float):
        assert got == want
        return
    assert got.strategy == want.strategy
    assert [dataclasses.astuple(t) for t in got.terms] == [
        dataclasses.astuple(t) for t in want.terms]
    assert got.total() == want.total() and got.total("ici") == want.total(
        "ici")


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_partials_equal_reference_at_world_size_one(softcap):
    rng = np.random.default_rng(7)
    B, S, H, Hk, D = 2, 12, 4, 2, 8
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    mask = np.arange(S)[None].repeat(B, 0) < np.array([[7], [12]])
    want = ref_attn.decode_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        length_mask=jnp.asarray(mask), attn_softcap=softcap)
    got = attention.decode_attention_partial(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        length_mask=torch.as_tensor(mask), attn_softcap=softcap)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    combined = jax.vmap(lambda wv, m, z: ref_attn.combine_decode_partials(
        wv, m, z, "i"), axis_name="i")(*(x[None] for x in want))[0]
    out = attention.combine_decode_partials(*got, None)
    np.testing.assert_allclose(out.numpy(), np.asarray(combined), rtol=1e-5,
                               atol=1e-6)
    full = attention.decode_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        length_mask=torch.as_tensor(mask), attn_softcap=softcap)
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_chunked_attention_q_offset_equals_reference():
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 16, 3, 8
    q = rng.standard_normal((B, 4, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    for offset in (0, 4, 12):
        want = ref_attn.chunked_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=6,
            q_chunk=2, q_offset=offset, shard_divisor=4)
        got = attention.chunked_causal_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            window=6, q_chunk=2, q_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
