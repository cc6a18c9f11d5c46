"""A cell's traced window read by the program's own spans and counters, in
one process on the card.

    python3 gpubench/spantrace.py --workload <cell> --seeds 11,12 \\
        --seconds 10 [--out spans.jsonl]

For each seed it sets the cell up as :func:`gpubench.harness.run` does,
runs the window under :func:`gpubench.devtrace.profiler`, and prints one
JSON line: the reading of :func:`gpubench.spans.read`, the program's
counters, and the per-layer metrics that read them (``metrics/<name>.py``)
beside ``aggregate_share_pct`` and ``idle_pct`` of the same window, and
the shares of busy time by kind again with each kernel put to its
operation by the operation's id alone (:func:`kinds_by_ops`).  The
tables of device seconds by phase and block and of idle seconds by span
end its standard error.  No reference runs, so nothing is judged
``correct``; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
#: The metrics of the spans and counters, and the trace's own beside them.
METRICS = ("aggregate_span_pct", "step_idle_pct", "optimizer_ms",
           "recompute_pct", "pad_rows_pct", "layout_s",
           "aggregate_share_pct", "idle_pct")


def kinds_by_ops(prof, busy_s: float) -> dict:
    """Each kind's share of ``busy_s`` (%) by :mod:`gpubench.devtrace`'s
    rules, message passing found over the host events that are no runtime
    call: ``devtrace.events`` also counts the runtime calls' own
    correlation ids, another count in which a kernel's operation id may
    recur."""
    import torch

    from gpubench import devtrace

    host, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((ev.duration_ns(), ev.name(),
                        ev.linked_correlation_id()))
        elif (ev.start_thread_id() == ev.end_thread_id()
              and not ev.linked_correlation_id()):
            host.append(devtrace.host_event(ev))
    under = devtrace.message_passing_ops(host)
    out = dict.fromkeys(devtrace.KINDS, 0.0)
    for ns, name, op in dev:
        out[devtrace.kind(name, op in under)] += 100.0 * ns / 1e9 / busy_s
    return out


def traced(cell: dict, seed: int, seconds: float, device) -> dict:
    """One seed's set-up and traced window; the record the readers read,
    with ``spans`` and ``counters``."""
    import torch

    from gpubench import devtrace, harness, spans
    from gpubench.program import counters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters.reset()
    t0 = time.perf_counter()
    side = harness.program_side(cell, seed, device)
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    with devtrace.profiler(cuda) as prof:
        win = harness.window(side["state"], seconds, device,
                             harness.WARM_STEPS)
    summary = devtrace.summarize(*devtrace.events(prof), win["window_s"])
    reading = spans.read(prof, win["window_s"])
    by_ops = (kinds_by_ops(prof, summary["busy_s"])
              if summary["busy_s"] > 0 else None)
    stats, times = side["data"]["stats"], side["times"]
    del side, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {**win, "setup_s": setup_s, "trace": summary, "spans": reading,
            "kinds_by_ops_pct": by_ops,
            "counters": counters.read(), "stats": stats, "times": times,
            "chips": cell["chips"], "dtype": cell["config"]["dtype"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from gpubench import harness, peaks, spans

    cell = harness.load_cell(args.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = peaks.power_limit()
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = traced(cell, seed, args.seconds, dev)
        metrics = {m: harness.module("metrics", m).read(rec)
                   for m in METRICS}
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "card": card, "metrics": metrics,
                           **{k: rec[k] for k in (
                               "steps", "window_s", "setup_s",
                               "kinds_by_ops_pct", "spans",
                               "counters", "stats", "times")}})
        print(f"# {args.workload} seed {seed} | {card}", file=sys.stderr)
        for text in spans.table(rec["spans"]):
            print(f"# {text}", file=sys.stderr)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
