"""Training under a sharding policy, held to the reference's own policy
steps.

The LM battery: for the smollm-135m (dense, context-parallel attention),
gemma2-2b (GQA, soft-caps, tied embedding) and qwen3-moe-30b-a3b (MoE with
expert parallelism) smoke configs, on the (2, 4) and (4, 2) meshes, on the
unchunked and the sequence-chunked CE paths, three steps of the reference's
``make_train_step(cfg, adamw(3e-4, weight_decay=0.1),
policy=make_policy(mesh))`` on 8 fake CPU devices
(``tests/torch_policy_train_ref.py``) against three steps of the port's
``launch.steps.lm_train_cell`` on 8 gloo ranks
(``tests/torch_policy_train_checks.py``), from the reference's
``init_params``: every loss, the parameters (over the entries whose first
gradient passes 1e-3 of their leaf's largest) and both moments within
1e-4.  Under EP the MoE step is not the single-device step (capacity comes
from each rank's tokens), so it is held to the reference's policy step.
The port shards with FSDP at 4 KiB, so the smoke configs' matrices take
the all-gather path; the collective ledger of the first step must equal
``comm_model.dp_gradient_sync`` for the dp-replicated leaves and
``allgather_bytes`` / ``reduce_scatter_bytes`` for the FSDP ones, to the
byte.

The DLRM battery runs the reference's ``_dlrm_plan`` train step (smoke
widths, tables of 3 to 128 rows: some shard over every rank, some over
``model``, some replicate) against ``launch.steps.dlrm_train_cell``
within 1e-5, with every zero row exactly zero at the end.  The seeded
per-shard draw is checked on 4 and 8 ranks.

Each job is one subprocess with its own time limit; the reference's and
the port's run concurrently.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_arch as ref_get_arch
from repro.models import dlrm as ref_dlrm
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.core import comm_model
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import dlrm
from repro_torch.models import transformer as tr
from repro_torch.tree import is_spec, tree_paths

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(__file__).parent / "torch_policy_train_checks.py"
REF = Path(__file__).parent / "torch_policy_train_ref.py"
#: Each job's subprocess (8 ranks or 8 fake devices, then the job).
JOB_TIMEOUT = 400

LM_NAMES = ("smollm-135m", "gemma2-2b", "qwen3-moe-30b-a3b")
MESHES = ((2, 4), (4, 2))
CASES = [(name, shape, chunked) for name in LM_NAMES for shape in MESHES
         for chunked in (False, True)]
STEPS = 3
#: (threshold, chunk) forcing the sequence-chunked CE at S = 32: 2 chunks.
CHUNKING = (0, 16)
#: FSDP's threshold in the port's run: the smoke matrices shard over dp.
MIN_BYTES = 4096
B, S = 4, 32
LM_TOL = 1e-4
DLRM_TOL = 1e-5
#: Parameters are compared where the first gradient passes this fraction
#: of the leaf's largest (AdamW moves a near-zero gradient's entry by the
#: full rate in either direction).
GRAD_FLOOR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(script: Path, job: str, data_path: Path, out: Path):
    return subprocess.Popen([sys.executable, str(script), job,
                             str(data_path), str(out)], cwd=ROOT,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, out: Path):
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"timed out\n{stdout}\n{stderr}")
    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    with open(out, "rb") as f:
        return pickle.load(f)


def _run_both(tmp: Path, job: str, data: dict, splits=None) -> tuple:
    """The reference's and the port's runs of ``job``, concurrently; the
    reference's cases split over one process per entry of ``splits``
    (lists of cases), since its compiles dominate."""
    path = tmp / f"{job}.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    port = _start(PORT, job, path, tmp / f"{job}_port.pkl")
    refs = []
    for i, cases in enumerate(splits or [None]):
        src = path
        if cases is not None:
            src = tmp / f"{job}_{i}.pkl"
            with open(src, "wb") as f:
                pickle.dump({**data, "cases": cases}, f)
        out = tmp / f"{job}_ref{i}.pkl"
        refs.append((_start(REF, job, src, out), out))
    ref: dict = {}
    for proc, out in refs:
        part = _finish(proc, out)
        ref = {**ref, **part} if splits else part
    return ref, _finish(port, tmp / f"{job}_port.pkl")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _rel(got, want, mask=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) + 1e-12
    diff = np.abs(got - want)
    if mask is not None:
        diff = diff[mask]
    return float(np.max(diff, initial=0.0) / scale)


def _compare_state(got: dict, want: dict, tol: float) -> None:
    mus = _leaves(want["first_mu"])
    for key in ("params", "mu", "nu"):
        gl, wl = _leaves(got[key]), _leaves(want[key])
        assert len(gl) == len(wl) == len(mus)
        for i, (g, w, m) in enumerate(zip(gl, wl, mus)):
            assert g.shape == w.shape, (key, i, g.shape, w.shape)
            mask = None
            if key == "params":
                mask = np.abs(m) > GRAD_FLOOR * np.max(np.abs(m))
            err = _rel(g, w, mask)
            assert err < tol, (key, i, w.shape, err)


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    params, batch = {}, {}
    for name in LM_NAMES:
        cfg = ref_get_arch(name).make_smoke_config()
        params[name] = _np(ref_tf.init_params(cfg, jax.random.key(0)))
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        batch[name] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    data = {"cases": CASES, "params": params, "batch": batch,
            "steps": STEPS, "chunking": CHUNKING, "min_bytes": MIN_BYTES}
    splits = [[c for c in CASES if c[1] == shape] for shape in MESHES]
    return _run_both(tmp_path_factory.mktemp("lm"), "lm", data, splits)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x"
                         f"{c[1][1]}-{'chunked' if c[2] else 'whole'}")
def test_lm_policy_step_matches_reference(lm_runs, case):
    ref, port = lm_runs
    want, got = ref[case], port[case]
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(g - w) / abs(w) < LM_TOL, (i, g, w)
    _compare_state(got, want, LM_TOL)


def _abstract_policy(shape):
    return make_policy(AbstractMesh(("data", "model"), shape))


def _local_bytes(shape, spec, policy, itemsize=4) -> int:
    """Bytes of one rank's block of a leaf of ``shape`` laid out by
    ``spec``."""
    n = 1
    for s in shape:
        n *= s
    for entry in spec:
        if entry is not None:
            n //= policy.size(entry)
    return n * itemsize


@pytest.mark.parametrize("case", [c for c in CASES if not c[2]],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_lm_policy_ledger_equals_the_traffic_models(lm_runs, case):
    """The first step's gradient all-reduce over dp of the dp-replicated
    leaves is ``dp_gradient_sync`` of their bytes; each FSDP leaf's
    all-gathers and reduce-scatters are ``allgather_bytes`` /
    ``reduce_scatter_bytes`` of its tensor-parallel block, gathered once
    for the top-level leaves and twice for a block's (the forward and the
    group remat's recompute), scattered once.  Exact to the byte."""
    _, port = lm_runs
    name, shape, _ = case
    cfg = get_arch(name).make_smoke_config()
    policy = _abstract_policy(shape)
    specs = tr.train_pspecs(cfg, policy, min_bytes=MIN_BYTES)
    shapes = dict(tree_paths(tr._param_shapes(cfg), is_spec))
    dp = policy.dp
    replicated, gather, scatter, n_fsdp = 0, 0.0, 0.0, 0
    for path, spec in tree_paths(specs, is_spec):
        dp_dims = [d for d, e in enumerate(spec) if e == policy.dp_spec]
        if not dp_dims:
            replicated += _local_bytes(shapes[path], spec, policy)
            continue
        n_fsdp += 1
        block = _local_bytes(shapes[path], spec, policy) * dp
        gathers = 2 if path[0] == "blocks" and cfg.remat != "none" else 1
        gather += gathers * comm_model.allgather_bytes(block, dp)
        scatter += comm_model.reduce_scatter_bytes(block, dp)
    assert n_fsdp > 0
    by = {}
    for kind, tag, _, _, wire in port[case]["ledger"]:
        by[(tag, kind)] = by.get((tag, kind), 0.0) + wire
    assert by[("grad_dp", "all-reduce")] == comm_model.dp_gradient_sync(
        replicated, dp).total("ici")
    assert by[("fsdp", "all-gather")] == gather
    assert by[("fsdp", "reduce-scatter")] == scatter


@pytest.fixture(scope="module")
def dlrm_runs(tmp_path_factory):
    ref_cfg = ref_get_arch("dlrm-mlperf").make_smoke_config()
    cfg = dlrm.DLRMConfig(**{f.name: getattr(ref_cfg, f.name)
                             for f in dataclasses.fields(ref_cfg)})
    params = _np(ref_dlrm.init_params(ref_cfg, jax.random.key(0)))
    from repro_torch.data import synthetic
    batch = synthetic.criteo_batch(0, 0, batch=64, n_dense=cfg.n_dense,
                                   vocab_sizes=cfg.vocab_sizes,
                                   multi_hot=cfg.multi_hot)
    data = {"cfg": ref_cfg, "port_cfg": cfg, "params": params,
            "batch": batch, "steps": STEPS, "shape": (2, 4)}
    return cfg, _run_both(tmp_path_factory.mktemp("dlrm"), "dlrm", data)


def test_dlrm_policy_step_matches_reference(dlrm_runs):
    cfg, (ref, port) = dlrm_runs
    policy = _abstract_policy((2, 4))
    kinds = {dlrm.table_shards(v, policy) for v in cfg.vocab_sizes}
    assert kinds == {1, policy.tp, policy.n_devices}
    for i, (g, w) in enumerate(zip(port["losses"], ref["losses"])):
        assert abs(g - w) / abs(w) < DLRM_TOL, (i, g, w)
    _compare_state(port, ref, DLRM_TOL)


def test_dlrm_policy_step_keeps_zero_rows_zero(dlrm_runs):
    _, (_, port) = dlrm_runs
    assert port["pad_max"] == 0.0
    tags = {(tag, kind) for kind, tag, *_ in port["ledger"]}
    assert ("grad_dp", "all-reduce") in tags
    assert ("embedding", "all-gather") in tags   # the split's backward


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (8, (2, 4))])
def test_seeded_shard_draw(tmp_path, world, shape):
    """``shard_transformer_tree(None, ...)`` on 4 and 8 ranks: a
    replicated leaf is the same on every rank, and a block at a given
    index along its spec axes is the same wherever it is drawn; the blocks
    tile the global shape."""
    data = {"names": ("gemma2-2b", "qwen3-moe-30b-a3b"),
            "shapes": {world: shape}, "min_bytes": MIN_BYTES, "seed": 3}
    path = tmp_path / "draw.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    out = tmp_path / "draw_out.pkl"
    ranks = _finish(_start(PORT, f"draw{world}", path, out), out)
    assert len(ranks) == world
    for name in data["names"]:
        cfg = get_arch(name).make_smoke_config()
        policy = _abstract_policy(shape)
        shapes = dict(tree_paths(tr._param_shapes(cfg), is_spec))
        for path_ in ranks[0][name]:
            seen: dict[int, np.ndarray] = {}
            for r in ranks:
                axes, coord, block = r[name][path_]
                if coord in seen:
                    assert np.array_equal(seen[coord], block), (name, path_)
                seen[coord] = block
            n_blocks = policy.size(axes) if axes else 1
            assert len(seen) == n_blocks, (name, path_)
            total = sum(b.size for b in seen.values())
            assert total == int(np.prod(shapes[path_])), (name, path_)
            if path_[-1] in ("ln1", "ln2", "final_norm"):
                assert all(not b.any() for b in seen.values())
            elif n_blocks > 1:
                blocks = list(seen.values())
                assert not np.array_equal(blocks[0], blocks[1])
