"""The readings that set a cell's limits, in one process on the card.

    python3 gpubench/calibrate.py --workload <cell> --mode <mode> \\
        --seeds 11,12,13 [--out chiprun_out/calibrate.jsonl]

For each seed it builds the cell's inputs and weights and prints the
four numbers of :mod:`gpubench.check` (one JSON line a seed) for
``--mode``:

* ``sound``: the program's three checked steps against the reference;
* ``control``: the reference itself in the program's place, in float32
  with TF32 on (the precision below the configuration's float32), against
  the float64 reference;
* ``half_batch``: the program with that fault planted
  (:func:`gpubench.harness.planted`); ``unchanged`` reads 1 by
  construction and needs no run.

No window runs; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def readings(cell: dict, seed: int, mode: str, device) -> dict:
    import torch

    from gpubench import check, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if mode == "control":
        data = harness.inputs(cell, seed, device)
        data.pop("inputs", None)
        conf = cell["config"]
        ref = harness.module("reference", conf["arch"])
        params = harness.draw_weights(ref.layout(conf["model"]), seed, device)
        start = {k: v.detach().cpu() for k, v in
                 harness.flat(params).items()}
        del params
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        prog = harness.reference_side(cell, data, start, device,
                                      dtype=torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        side = harness.program_side(cell, seed, device,
                                    fault=None if mode == "sound" else mode)
        data, start, prog = side["data"], side["start"], side["readings"]
        del side
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref_read = harness.reference_side(cell, data, start, device)
    numbers = check.compare(prog, ref_read)
    return {"seed": seed, "mode": mode,
            "numbers": {k: v[0] for k, v in numbers.items()},
            "worst": {k: v[1] for k, v in numbers.items()},
            "stats": data["stats"], "program_s": t1 - t0,
            "reference_s": time.perf_counter() - t1,
            "loss": [prog["loss"], ref_read["loss"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", "half_batch"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from gpubench import harness, peaks

    cell = harness.load_cell(args.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = peaks.power_limit()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({**readings(cell, seed, args.mode, dev),
                           "card": card})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
