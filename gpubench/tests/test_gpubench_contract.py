"""``BENCHMARK.json`` against the benchmark's contract, and every file it
finds by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_and_cells():
    paths = BENCH["paths"]
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert c["file"] not in files
        files.add(c["file"])
        conf = json.loads((CHECKOUT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (CHECKOUT / "gpubench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        limits = json.loads((CHECKOUT / "gpubench" / "workloads"
                             / f"{w['name']}.json").read_text())["limits"]
        assert {"loss_step1", "grad", "delta"} <= set(limits) <= {
            "loss_step1", "grad", "delta", "grad_diff"}


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    mod = importlib.import_module(f"gpubench.metrics.{name}")
    assert callable(mod.read)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_config_has_a_reference_and_program_glue(name):
    conf = json.loads((CHECKOUT / next(
        c["file"] for c in BENCH["configs"] if c["name"] == name)).read_text())
    arch = conf["arch"].replace("-", "_")
    ref = importlib.import_module(f"gpubench.reference.{arch}")
    for fn in ("layout", "loss", "flops", "aggregate_bytes"):
        assert callable(getattr(ref, fn))
    assert (CHECKOUT / "gpubench" / "program" / f"{arch}.py").is_file()
    law = importlib.import_module(f"gpubench.laws.{conf['graph']['law']}")
    assert callable(law.pairs)


@pytest.mark.parametrize("name", sorted({w["traffic"]
                                         for w in BENCH["workloads"]}))
def test_every_traffic_mix_has_its_kind(name):
    mix = json.loads((CHECKOUT / "gpubench" / "traffic"
                      / f"{name}.json").read_text())
    kind = importlib.import_module(f"gpubench.kinds.{mix['kind']}")
    for fn in ("inputs", "program_batches", "ref_batch"):
        assert callable(getattr(kind, fn))
