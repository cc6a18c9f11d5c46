"""The dry run's serving plans run for real on a small gloo mesh.

The production serving cells take two paths that a (1, 1) mesh never
reaches: FSDP serving weights gathered one layer at a time (arctic-480b's
prefill and decode) and the retrieval's top-k merged across ranks.
``tests/torch_dryrun_serving_checks.py`` runs the plans' own steps on 4
gloo ranks at smoke sizes, with FSDP forced, and this file holds them to
the single-device paths on the whole weights (themselves held to the
reference in ``tests/test_torch_smoke_archs.py`` and
``tests/test_torch_dlrm.py``).  A decode whose cache splits over the
in-pod axes of a ("pod", "data", "model") mesh, the layout of
``long_500k``, is held the same way.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = Path(__file__).parent / "torch_dryrun_serving_checks.py"
#: f32 on both sides; the sharded products sum in another order.
REL_TOL = 1e-4
LM_ARCHS = ("arctic-480b", "gemma2-2b")
WORLD = 4


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("serving") / "ranks.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(SCRIPT), str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    with open(out, "rb") as f:
        ranks = pickle.load(f)
    assert len(ranks) == WORLD
    return ranks


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("step", ("prefill", "decode"))
def test_fsdp_serving_matches_one_device(runs, arch, step):
    for rank in runs:
        res = rank[f"lm/{arch}"]
        assert res[step].shape == res[f"{step}_1"].shape
        assert _rel(res[step], res[f"{step}_1"]) < REL_TOL
        # The layers really were FSDP blocks, gathered on use.
        assert res["fsdp_leaves"] > 0
        assert res["by_tag"]["fsdp"]["all-gather"] > 0


def test_retrieval_merges_every_ranks_top_k(runs):
    for rank in runs:
        res = rank["retrieval"]
        np.testing.assert_array_equal(res["idx"], res["idx_1"])
        assert _rel(res["vals"], res["vals_1"]) < REL_TOL
        assert res["by_tag"]["retrieval"]["all-gather"] > 0


def test_retrieval_ranks_agree(runs):
    first = runs[0]["retrieval"]
    for rank in runs[1:]:
        np.testing.assert_array_equal(rank["retrieval"]["idx"], first["idx"])
        np.testing.assert_array_equal(rank["retrieval"]["vals"],
                                      first["vals"])


def test_cache_over_the_in_pod_axes(runs):
    for rank in runs:
        res = rank["pod"]
        assert res["cache_shards"] == 2
        assert _rel(res["got"], res["want"]) < REL_TOL
