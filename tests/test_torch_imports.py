"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor the reference package ``repro``, and ``chip_smoke.py`` refuses
to report a result without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro")
#: The registry's modules: every architecture's config and the bridges.
CONFIG_MODULES = ("base", "scenarios", "arctic_480b", "dlrm_mlperf",
                  "equiformer_v2", "gatedgcn", "gcn_cora", "gemma2_2b",
                  "granite_3_2b", "meshgraphnet", "qwen3_moe_30b_a3b",
                  "smollm_135m")

#: The training substrate and trainer.
TRAIN_MODULES = ("tree", "optim/__init__", "optim/optimizers",
                 "optim/compression", "checkpoint/__init__",
                 "checkpoint/manager", "distributed/resilience",
                 "launch/__init__", "launch/train", "launch/steps")

#: The distributed substrate: collectives, sharding, ring SpMM, GPipe, the
#: meshes and the byte models.
DISTRIBUTED_MODULES = ("distributed/comm", "distributed/sharding",
                       "distributed/ring", "distributed/pipeline_par",
                       "launch/mesh", "core/comm_model")

#: The dry run and the H100 machine model.
DRYRUN_MODULES = ("core/gpu_model", "launch/counters", "launch/dryrun")

#: The MoE layer and every module of the GNN models.
GNN_MODULES = ("moe", "gnn/__init__", "gnn/graph", "gnn/layers", "gnn/gcn",
               "gnn/gatedgcn", "gnn/meshgraphnet", "gnn/equiformer_v2")

#: A meta-path finder that refuses jax*, and exactly ``repro`` and
#: ``repro.*`` (``repro_torch`` must load).
_REFUSE = r"""
import importlib, pkgutil, runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.startswith("jax") or name == "repro" or name.startswith("repro."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""

#: Imports every module of the port with the finder in place.
_BLOCKER = _REFUSE + r"""
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.startswith("jax") or m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
print("imported", len(names), "modules:", " ".join(names))
"""

#: One dry-run cell through the CLI with the finder in place.
_DRYRUN_RUNS = _REFUSE + r"""
sys.argv = ["python -m repro_torch.launch.dryrun", "--mesh", "single",
            "--arch", "gcn-cora", "--shape", "molecule", "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__",
                     alter_sys=True)
except SystemExit as exc:
    assert exc.code == 0, exc.code
leaked = [m for m in sys.modules if m.startswith("jax") or m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
"""

#: ``python -m repro_torch.analysis --help`` with the finder in place.
_ANALYSIS_HELP = _REFUSE + r"""
sys.argv = ["python -m repro_torch.analysis", "--help"]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__",
                     alter_sys=True)
except SystemExit as exc:
    assert exc.code == 0, exc.code
leaked = [m for m in sys.modules if m.startswith("jax") or m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
"""


#: The MoE serving path on the CPU with the finder in place: a registry
#: smoke config built, drawn, prefilled and decoded one step (a module that
#: imported jax or the reference lazily, on first use, would fail here).
_MOE_SERVES = _REFUSE + r"""
import torch
from repro_torch import params
from repro_torch.configs import get_arch
from repro_torch.models import moe, transformer as tr

for arch in ("qwen3-moe-30b-a3b", "arctic-480b"):
    cfg = get_arch(arch).make_smoke_config()
    model = params.draw_transformer(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(0))
    lg, cache = tr.make_prefill_step(cfg, max_seq=17)(model, tokens)
    lg, _ = tr.make_serve_step(cfg, 17)(model, cache, lg.argmax(-1, keepdim=True), 16)
    _, aux = tr.forward_hidden(cfg, model, tokens)
    assert bool(torch.isfinite(lg).all()) and float(aux) > 0
leaked = [m for m in sys.modules if m.startswith("jax") or m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
print("served", moe.__name__)
"""


#: ``python -m repro_torch.launch.train`` on the CPU with the finder in
#: place, one family after another (EquiformerV2 reads the Wigner data
#: lazily): each run must finish with its loss logged.
_TRAINS = _REFUSE + r"""
import logging, tempfile
from repro_torch.launch import train

for arch in ("smollm-135m", "gcn-cora", "equiformer-v2", "dlrm-mlperf"):
    with tempfile.TemporaryDirectory() as d:
        code = train.main(["--arch", arch, "--steps", "2", "--device", "cpu",
                           "--ckpt-dir", d, "--gnn-nodes", "32",
                           "--gnn-edges", "96", "--seq", "16"])
    assert code == 0, (arch, code)
leaked = [m for m in sys.modules if m.startswith("jax") or m == "repro" or m.startswith("repro.")]
assert not leaked, leaked
print("trained", train.__name__)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
    walked = set(proc.stdout.split())
    for name in ("audit", "lint", "mutations", "tracer", "units",
                 "__main__"):
        assert f"repro_torch.analysis.{name}" in walked, name
    assert "repro_torch.data.sampler" in walked
    for name in ("repro_torch.core.tune", "repro_torch.core.schedule_cache",
                 "repro_torch.api.serve"):
        assert name in walked, name
    for name in CONFIG_MODULES:
        assert f"repro_torch.configs.{name}" in walked, name
    for name in GNN_MODULES:
        module = name.replace("/__init__", "").replace("/", ".")
        assert f"repro_torch.models.{module}" in walked, name
    for name in ("repro_torch.distributed",
                 "repro_torch.distributed.trace_shard",
                 "repro_torch.data.wigner"):
        assert name in walked, name
    for name in TRAIN_MODULES + DISTRIBUTED_MODULES + DRYRUN_MODULES:
        module = name.replace("/__init__", "").replace("/", ".")
        assert f"repro_torch.{module}" in walked, name


def test_dry_run_cli_runs_with_jax_and_reference_blocked(tmp_path):
    """One production cell through ``python -m repro_torch.launch.dryrun``
    (a fake process group of 256 ranks, fake tensors) with jax and the
    reference refused at import."""
    proc = subprocess.run(
        [sys.executable, "-c", _DRYRUN_RUNS, str(tmp_path)], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[single] gcn-cora x molecule: OK" in proc.stdout
    assert (tmp_path / "single" / "gcn-cora__molecule.json").exists()


def test_training_runs_with_jax_and_reference_blocked():
    proc = subprocess.run([sys.executable, "-c", _TRAINS], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "trained repro_torch.launch.train" in proc.stdout


def test_moe_serves_with_jax_and_reference_blocked():
    proc = subprocess.run([sys.executable, "-c", _MOE_SERVES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served repro_torch.models.moe" in proc.stdout


def test_analysis_cli_help_runs_with_jax_and_reference_blocked():
    proc = subprocess.run([sys.executable, "-c", _ANALYSIS_HELP], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "usage: python -m repro_torch.analysis" in proc.stdout
    assert "--provenance" in proc.stdout and "--strict" in proc.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_reference(path):
    assert not _imported_roots(path) & set(BLOCKED)


def test_ast_scan_covers_the_registry_and_model_configs():
    """The scan above walks every file of the registry, of the MoE and GNN
    model modules, of the sharded trace pipeline, the Wigner data and the
    training substrate and trainer."""
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for name in CONFIG_MODULES + ("__init__",):
        assert f"configs/{name}.py" in scanned, name
    for name in GNN_MODULES:
        assert f"models/{name}.py" in scanned, name
    for name in ("distributed/__init__", "distributed/trace_shard",
                 "data/wigner") + TRAIN_MODULES + DISTRIBUTED_MODULES + \
            DRYRUN_MODULES:
        assert f"{name}.py" in scanned, name


#: Each name of ``repro_torch.distributed.__all__``, read in a fresh
#: process both ways: ``from repro_torch.distributed import NAME`` and as
#: an attribute of the package.
_DISTRIBUTED_NAME = _REFUSE + r"""
import importlib, types
name = sys.argv[1]
pkg = importlib.import_module("repro_torch.distributed")
ns = {}
exec(f"from repro_torch.distributed import {name} as got", ns)
got, attr = ns["got"], getattr(pkg, name)
assert got is attr, (got, attr)
home = got.__name__ if isinstance(got, types.ModuleType) else got.__module__
print("RESULT", got.__name__, home)
"""


def _distributed_names() -> list[str]:
    import repro_torch.distributed as pkg
    return list(pkg.__all__)


@pytest.mark.parametrize("name", _distributed_names())
def test_distributed_package_answers_each_name(name):
    """Each exported name resolves to itself (a submodule to that
    submodule, ``ShardingPolicy`` and ``make_policy`` to the sharding
    module's), by import and by attribute, with jax and the reference
    blocked."""
    proc = subprocess.run([sys.executable, "-c", _DISTRIBUTED_NAME, name],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got, home = proc.stdout.split("RESULT")[1].split()
    if name in ("ShardingPolicy", "make_policy"):
        assert (got, home) == (name, "repro_torch.distributed.sharding")
    else:
        assert got == home == f"repro_torch.distributed.{name}"


def _run_smoke(cwd: Path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("PYTHONPATH")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
