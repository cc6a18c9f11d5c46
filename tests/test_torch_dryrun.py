"""The dry run's plans and machine model held to the reference, and its
fake trace held to real runs on the CPU.

* Every (cell, mesh) pair of the 36 run cells on both production meshes:
  the port's ``launch.steps.build_cell`` against the reference's, built in
  a subprocess with 512 forced host devices and nothing compiled
  (``tests/torch_dryrun_ref.py``): the kind, ``model_flops`` (exactly),
  ``meta``, every argument's global shapes and dtypes, and one device's
  argument bytes (the reference's ``NamedSharding.shard_shape``s) equal to
  the port's ``state_bytes`` but for DLRM's zero row a table shard.
* ``core.gpu_model.roofline`` built with TPU v5e's constants gives the
  reference's ``tpu_model.roofline`` row field for field.
* Fake trace vs real run on the CPU at smoke sizes: the FLOPs are equal
  (``tests/torch_dryrun_checks.py``).
* K5's and K6's fake implementations refuse what the kernels refuse, and
  launch nothing; the MoE balance count stays ``torch.bincount``'s.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import tpu_model as jtm
from repro_torch.configs import all_cells, get_arch
from repro_torch.core.gpu_model import (H100_SXM, GPUHardware, dtype_key,
                                        roofline, tensor_core_padding_waste)
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": PRODUCTION_MESHES["single_pod"],
          "multi": PRODUCTION_MESHES["multi_pod"]}
PAIRS = [(m, a, s) for m in MESHES for a, s, st in all_cells() if st == "run"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _script(name: str, out: Path) -> dict:
    subprocess.run([sys.executable, str(ROOT / "tests" / name), str(out)],
                   env=_env(), check=True, timeout=900)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    return _script("torch_dryrun_ref.py",
                   tmp_path_factory.mktemp("ref") / "plans.json")


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, steps.GraphBatch):
        tree = {f: getattr(tree, f) for f in tree.__dataclass_fields__}
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _described(arg) -> list:
    return sorted([list(t.shape), dtype_key(t.dtype).replace(
        "fp32", "float32").replace("bf16", "bfloat16")]
        for t in _leaves(arg))


def test_all_72_pairs_are_planned():
    assert len(PAIRS) == 72


@pytest.mark.parametrize("mesh,arch,shape", PAIRS)
def test_plan_matches_the_reference(reference_plans, mesh, arch, shape):
    ref = reference_plans[f"{mesh}/{arch}/{shape}"]
    plan = steps.build_cell(arch, shape, MESHES[mesh])
    assert plan.kind == ref["kind"]
    assert plan.model_flops == ref["model_flops"]
    assert {k: str(v) for k, v in plan.meta.items()} == ref["meta"]
    assert len(plan.args) == len(ref["args"])
    for got, want in zip(plan.args, ref["args"]):
        assert _described(got) == sorted(want)
    # One device's argument bytes.  The port adds one zero row to each
    # sharded DLRM table (out-of-shard ids read it): in the tables and, for
    # training, in both AdamW moments.
    pad = 0
    if arch == "dlrm-mlperf":
        cfg = get_arch(arch).make_config()
        tables = plan.specs[0]["tables"]
        per = sum(cfg.embed_dim * 4 for s in tables if s[0] is not None)
        pad = per * (3 if plan.kind == "train" else 1)
    assert plan.pad_bytes == pad
    assert plan.state_bytes() == ref["shard_bytes"] + pad


# ---- the machine model -----------------------------------------------------

#: The reference's TPU v5e in the port's machine model: its bf16 peak, HBM
#: rate, per-link ICI rate (the fabric) and MXU tile.
V5E = GPUHardware(name="tpu-v5e", peak_flops_bf16=197e12,
                  hbm_bandwidth=819e9, hbm_bytes=16 * 2**30,
                  nvlink_bandwidth=50e9, network_bandwidth=50e9, mma_m=128)


def _same(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_roofline_under_tpu_constants_is_the_references():
    rng = np.random.default_rng(0)
    for i in range(32):
        kw = dict(cell=f"cell{i}", chips=int(rng.choice([1, 8, 256, 512])),
                  flops_per_chip=float(rng.uniform(0, 1e15)),
                  hbm_bytes_per_chip=float(rng.uniform(0, 1e12)),
                  collective_bytes_per_chip=float(rng.uniform(0, 1e11)),
                  model_flops=float(rng.uniform(0, 1e17)) if i % 4 else 0.0)
        got = roofline(**kw, dtype="bf16", hw=V5E)
        want = jtm.roofline(**kw)
        row, ref = got.row(), want.row()
        for key, value in ref.items():
            assert _same(row[key], value), (i, key, row[key], value)
        assert got.step_time_serial_s == want.step_time_serial_s
    for dim in (1, 64, 127, 128, 129, 1433, 4096):
        assert tensor_core_padding_waste(dim, V5E) == jtm.mxu_padding_waste(
            dim)


def test_h100_model_reads_its_peak_and_fabric():
    assert H100_SXM.sm_count == 132 and H100_SXM.mma_m == 64
    assert H100_SXM.peak_flops("bf16") == 989e12
    assert H100_SXM.peak_flops(torch.bfloat16) == 989e12
    assert H100_SXM.peak_flops(torch.float32) == 67e12
    assert H100_SXM.peak_flops("tf32") == 495e12
    with pytest.raises(ValueError):
        H100_SXM.peak_flops("int8")
    assert H100_SXM.fabric(8) == "nvlink" and H100_SXM.fabric(9) == "network"
    r = roofline(cell="c", chips=256, flops_per_chip=989e12,
                 hbm_bytes_per_chip=3.35e12 / 2, collective_bytes_per_chip=0,
                 model_flops=256 * 989e12 / 4, dtype=torch.float32)
    assert (r.peak_dtype, r.fabric) == ("fp32", "network")
    assert r.compute_s == 989e12 / 67e12 and r.dominant == "compute"
    # The report's own peak: a quarter of the fp32 step's time is useful.
    assert r.roofline_fraction == (256 * 989e12 / 4) / (256 * 67e12) / \
        r.step_time_s
    assert tensor_core_padding_waste(96) == 0.25


# ---- fake trace vs real run ------------------------------------------------

@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    return _script("torch_dryrun_checks.py",
                   tmp_path_factory.mktemp("checks") / "flops.json")


CHECK_CASES = ["granite-prefill", "qwen3-moe-prefill", "smollm-train",
               "gemma2-decode", "dlrm-train", "dlrm-serve", "dlrm-retrieval"]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_fake_trace_flops_equal_the_real_run(fake_and_real, case):
    got = fake_and_real[case]
    assert got["fake"] > 0
    assert got["fake"] == got["real"]
    assert got["fake_k5"] == got["real_k5"]
    assert (got["fake_k5"] > 0) == case.endswith("prefill")


# ---- K5 and K6 under a fake mode -------------------------------------------

def test_k5_fake_refuses_what_the_kernel_refuses():
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        def qkv(s=64, d=64, h=4, hk=2, dtype=torch.bfloat16):
            return (torch.empty(2, s, h, d, dtype=dtype),
                    torch.empty(2, s, hk, d, dtype=dtype),
                    torch.empty(2, s, hk, d, dtype=dtype))

        out = ops.flash_attention(*qkv(), window=16, softcap=30.0)
        assert out.shape == (2, 64, 4, 64) and out.dtype == torch.bfloat16
        for bad in (dict(d=8), dict(d=24), dict(d=272)):
            with pytest.raises(ValueError, match="head dim"):
                ops.flash_attention(*qkv(**bad))
        with pytest.raises(ValueError, match="block"):
            ops.flash_attention(*qkv(s=200))
        with pytest.raises(ValueError, match="Hk | H"):
            ops.flash_attention(*qkv(h=3))
        with pytest.raises(ValueError, match="dtype"):
            ops.flash_attention(*qkv(dtype=torch.float16))
        q, k, v = qkv()
        q.requires_grad_()
        with pytest.raises(ValueError, match="no backward"):
            ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before


def test_k6_fake_refuses_what_the_kernel_refuses():
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        table = torch.empty(1000, 64)
        ids = torch.empty(8, 3, dtype=torch.int32)
        out = ops.embedding_bag(table, ids)
        assert out.shape == (8, 64) and out.dtype == torch.float32
        feats = torch.empty(8, 2, 64)
        assert ops.embedding_bag(table, ids, out=feats[:, 1]).shape == (8, 64)
        with pytest.raises(ValueError, match="int32"):
            ops.embedding_bag(table, ids.long())
        with pytest.raises(ValueError, match="table"):
            ops.embedding_bag(torch.empty(10, 4, 4), ids)
        with pytest.raises(ValueError, match="dtype"):
            ops.embedding_bag(table.half(), ids)
        with pytest.raises(ValueError, match="out must be"):
            ops.embedding_bag(table, ids, out=torch.empty(8, 32))
        with pytest.raises(ValueError, match="hot"):
            ops.embedding_bag(table, torch.empty(8, 0, dtype=torch.int32))
    assert ops.LAUNCHES == before


def test_moe_balance_count_is_bincounts():
    torch.manual_seed(0)
    cfg = moe.MoEConfig(n_experts=128, top_k=8, d_ff_expert=16,
                        capacity_factor=1.0)
    x, w = torch.randn(512, 64), torch.randn(64, 128)
    idx, _, aux = moe.router_topk(x, w, cfg)
    with moe._ieee_fp32():
        logits = x.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    _, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    ce = torch.bincount(expert_idx.reshape(-1), minlength=cfg.n_experts).to(
        torch.float32) / x.shape[0]
    want = cfg.n_experts * torch.sum(probs.mean(dim=0) * ce) * \
        cfg.aux_loss_weight
    assert torch.equal(aux, want)
    with FakeTensorMode():   # the count runs under a fake trace
        _, _, fake_aux = moe.router_topk(torch.empty(512, 64),
                                         torch.empty(64, 128), cfg)
        assert fake_aux.shape == ()


def test_step_counter_splits_its_peak_by_op():
    from repro_torch.launch.counters import StepCounter

    counter = StepCounter()
    n = 256 * 256 * 4
    with FakeTensorMode():
        x = torch.zeros(256, 256)
        assert counter.hold([x]) == n
        with counter:
            y = x @ x
            z = y.exp()
    assert counter.peak == 3 * n
    assert counter.peak_by_op == {"held": n, "aten::mm": n, "aten::exp": n}
    del y, z
