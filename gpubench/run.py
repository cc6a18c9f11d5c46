"""Run one cell of ``BENCHMARK.json`` on the GPUs of this machine.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It exits 2, printing no result, without a
CUDA device or with fewer than the cell's chips.  The last line of its
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, which also end its standard error.  The program's
build and kernel caches live at fixed paths in the checkout
(``.gpubench-cache/``).  It exits 3, printing no result, if the program
loaded JAX or the JAX package.  A cell on more than one card is run by
``gpubench/multichip.py``'s ``run``, which returns the record that
:func:`gpubench.harness.run` returns (its peak the fullest card's); a
checkout without that file exits 2 on such a cell.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# The script's own folder would shadow standard modules by its file names.
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
#: Top-level modules that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")


def _environment() -> None:
    cache = CHECKOUT / ".gpubench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["REPRO_TORCH_TRACE_CACHE"] = "0"
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """The top-level names of ``sys.modules`` that are forbidden, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from gpubench import harness, peaks

    cell = harness.load_cell(args.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def say(msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)

    card = peaks.power_limit()
    if cell["chips"] == 1:
        record = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             dev, t_start=T_START, say=say)
    else:
        try:
            multichip = importlib.import_module("gpubench.multichip")
        except ModuleNotFoundError as e:
            if e.name != "gpubench.multichip":
                raise
            print(f"{args.workload}: this checkout runs no cell on more "
                  "than one card (no gpubench/multichip.py)", file=sys.stderr)
            return 2
        record = multichip.run(cell, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START, say=say)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": record["peak_bytes"],
              "power": card}
    result = {"correct": record["correct"], "attempted": record["attempted"],
              "failed": record["failed"],
              "metrics": harness.metrics(cell, record, bool(args.trace)),
              "device": device}
    if args.trace:
        t = record["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = t["breakdown"]
    checks = {k: {"value": record["numbers"][k][0], "limit": limit,
                  "worst": record["numbers"][k][1]}
              for k, limit in cell["limits"].items()}
    result["checks"] = checks
    say(f"{args.workload} seed {args.seed}: {record['steps']} steps in "
        f"{record['window_s']:.3f} s, set-up {record['setup_s']:.3f} s | "
        f"{card}")
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}; worst "
              f"{c['worst']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
