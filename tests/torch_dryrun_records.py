"""Shared by ``tests/test_torch_dryrun_*.py``: the port's dry-run CLI run
over a group of cells into a temporary directory, and the twins of
``tests/test_dryrun_results.py``'s four checks over its records.

Each test file runs one group (``python -m repro_torch.launch.dryrun
--mesh both --arch ... --shape ... --jobs 3``), so the groups trace in
parallel under ``pytest -n``."""

import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import all_cells
from repro_torch.core.gpu_model import H100_SXM
from repro_torch.distributed.sharding import make_policy
from repro_torch.launch import steps
from repro_torch.launch.dryrun import KNOWN_FAILURES
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": 256, "multi": 512}
RUN_CELLS = [(a, s) for a, s, st in all_cells() if st == "run"]

#: Cells whose traced peak passes the card's 80 GB, with the peak the dry
#: run reckons (bytes a rank) and why.  No activation checkpointing in the
#: port's steps: a 480B-parameter Adam step keeps 35 layers' activations
#: for the backward on 256 or 512 ranks, qwen3-moe's 48 on 256, and
#: MeshGraphNet's 15 layers of 3.87M (256) or 1.93M (512) edges x 128
#: channels keep every edge MLP's input.
OVERCAP = {
    ("qwen3-moe-30b-a3b", "train_4k", "single"): 114.82e9,
    ("arctic-480b", "train_4k", "single"): 161.19e9,
    ("arctic-480b", "train_4k", "multi"): 82.06e9,
    ("meshgraphnet", "ogb_products", "single"): 323.66e9,
    ("meshgraphnet", "ogb_products", "multi"): 161.85e9,
}


def run_cli(out: Path, archs, shapes=None, jobs: int = 3) -> dict:
    """The CLI over ``archs`` x ``shapes`` on both meshes; returns its
    exit code, output and ``{(mesh, arch, shape): record}``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
           "both", "--arch", ",".join(archs), "--jobs", str(jobs), "--out",
           str(out)]
    if shapes:
        cmd += ["--shape", ",".join(shapes)]
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    records = {}
    for mesh in MESHES:
        for path in sorted((out / mesh).glob("*.json")):
            rec = json.loads(path.read_text())
            records[(mesh, rec["arch"], rec["shape"])] = rec
    return {"rc": done.returncode, "stdout": done.stdout,
            "stderr": done.stderr, "records": records}


def group_cells(archs, shapes=None) -> list:
    return [(a, s) for a, s in RUN_CELLS
            if a in archs and (shapes is None or s in shapes)]


def check_present_and_ok(run: dict, cells: list, mesh: str) -> None:
    missing, failed = [], []
    for arch, shape in cells:
        rec = run["records"].get((mesh, arch, shape))
        if rec is None:
            missing.append((arch, shape))
        elif not rec.get("ok"):
            failed.append((arch, shape, rec.get("error")))
    assert not missing, f"missing cells: {missing}\n{run['stderr'][-3000:]}"
    known = [(a, s) for a, s, _ in failed if (a, s) in KNOWN_FAILURES]
    assert [(a, s) for a, s, _ in failed] == known, failed
    for arch, shape, error in failed:
        assert "edge chunks under a policy" in error, error
    # One line a cell, and exit 1 on any failure, as the reference's CLI.
    lines = [ln for ln in run["stdout"].splitlines()
             if ln.startswith(f"[{mesh}]") and ": SKIP " not in ln]
    assert len(lines) == len(cells), run["stdout"]
    failures = any(not r["ok"] for r in run["records"].values())
    assert run["rc"] == (1 if failures else 0), run["stdout"]


def check_memory_fits(run: dict, cells: list, mesh: str) -> None:
    for arch, shape in cells:
        rec = run["records"][(mesh, arch, shape)]
        if not rec["ok"]:
            continue
        assert rec["chips"] == MESHES[mesh]
        peak = rec["memory"]["peak_bytes"]
        assert peak >= rec["memory"]["state_bytes"], (arch, shape)
        reckoned = OVERCAP.get((arch, shape, mesh))
        if reckoned is None:
            assert peak < H100_SXM.hbm_bytes, (
                f"{arch}/{shape} on {mesh}: {peak / 1e9:.2f} GB > HBM")
        else:
            assert abs(peak - reckoned) < 0.01 * reckoned, (arch, shape,
                                                           peak)


def check_roofline_inputs(run: dict, cells: list, mesh: str) -> None:
    for arch, shape in cells:
        rec = run["records"][(mesh, arch, shape)]
        if not rec["ok"]:
            continue
        assert rec["cost"]["flops"] > 0, (arch, shape)
        assert rec["cost"]["op_bytes"] > 0, (arch, shape)
        assert rec["model_flops"] > 0, (arch, shape)
        assert "wire_bytes_per_chip" in rec["collectives"]
        assert set(rec["no_counterpart"]) == {"bytes_accessed",
                                              "bf16_arg_bytes"}
        row = rec["roofline"]
        assert row["chips"] == MESHES[mesh] and row["fabric"] == "network"
        assert row["step_time_s"] == max(row["compute_s"], row["memory_s"],
                                         row["collective_s"])
        assert row["memory_s"] == rec["cost"]["op_bytes"] / \
            H100_SXM.hbm_bandwidth


def check_multipod_shards(run: dict, cells: list) -> None:
    """Train cells: the FLOPs a chip at 512 chips at most 1.05x those at
    256 (the pod axis shards the batch rather than replicating work)."""
    n = 0
    for arch, shape in cells:
        single = run["records"][("single", arch, shape)]
        multi = run["records"][("multi", arch, shape)]
        if not single["ok"] or single["kind"] != "train":
            continue
        f1, f2 = single["cost"]["flops"], multi["cost"]["flops"]
        assert f2 <= f1 * 1.05, (arch, shape, f1, f2)
        n += 1
    assert n


def check_gnn_ledger(run: dict, cells: list) -> None:
    """At world 256 each GNN cell's ledger equals ``gnn_policy_traffic``
    exactly (the readout's few scalars are not modelled)."""
    policy = make_policy(PRODUCTION_MESHES["single_pod"])
    for arch, shape in cells:
        rec = run["records"][("single", arch, shape)]
        if not rec["ok"]:
            continue
        plan = steps.build_cell(arch, shape, PRODUCTION_MESHES["single_pod"])
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(plan.args[0]))
        want = steps.gnn_policy_traffic(arch, steps.gnn_config(arch, shape),
                                        policy, plan.meta["N"], param_bytes)
        got = rec["collectives"]["by_tag"]
        for (tag, kind), value in want.items():
            assert got[tag][kind] == value, (arch, shape, tag, kind)
        assert set(got) == {"gnn_gather", "grad_dp", "gnn_readout"}
