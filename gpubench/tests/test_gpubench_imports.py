"""What the benchmark may import: never JAX or the JAX package, compared
by whole top-level names (``repro_torch`` is not ``repro``), and the
references nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
PACKAGE = CHECKOUT / "gpubench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    return names


def _sources():
    return sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(PACKAGE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path) if not n.startswith(".")}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    names = _imports(path)
    tops = {n.split(".")[0] for n in names if not n.startswith(".")}
    assert tops <= {"__future__", "math", "dataclasses", "typing", "torch"}
    assert all(not n.lstrip(".").startswith("program")
               and n not in ("..", "..program") for n in names)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(CHECKOUT / "src"),
                                         str(CHECKOUT)])
    return env


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(PACKAGE / "run.py"), "--workload",
         "gcn-products-fullbatch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=CHECKOUT, env={**_env(), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, time, json\n"
        "sys.argv = ['run.py']\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gpubench import harness\n"
        "from gpubench.tests import cells\n"
        "for make in (cells.gcn, cells.equiformer):\n"
        "    harness.run(make(), 3, 0.0, False, 'cpu',\n"
        "                t_start=time.perf_counter(), say=lambda m: None)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('bench_run', "
        f"{str(PACKAGE / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "sys.modules['repro_torchlike'] = sys\n"
        "sys.modules['repro.core'] = sys\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    first, second = out.stdout.strip().splitlines()[-2:]
    assert first == "[]"
    assert second == '["repro"]'
