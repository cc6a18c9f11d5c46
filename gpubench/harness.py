"""One run of one training cell: inputs and weights from the seed, the
program's train cell, its three warm steps (the first of them the checked
steps), the measured window, and the comparison with the plain reference.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found by name: the configuration (``configs/<config>.json``, the file the
entry names), the traffic mix (``traffic/<traffic>.json``), the limits of
its comparison (``workloads/<cell>.json``), the reference and the
program's batches of its architecture (``reference/<arch>.py``,
``program/<arch>.py``), its traffic kind (``kinds/<kind>.py``, the ``kind`` the mix's file
names), the law of its graph (``laws/<law>.py``) and one reader a metric
(``metrics/<metric>.py``).  A cell on more than one card is run by
``multichip.py``, which a checkout may add.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import time
from pathlib import Path

import torch

from . import check, devtrace, graphs
from .reference.common import Leaf, adamw_steps, flat, unflat

ROOT = Path(__file__).resolve().parent
#: The program's steps in set-up: the first ones are the checked steps
#: (a cell's ``reference_steps``, 3 unless its limits file says fewer), and
#: all of them warm the shapes the window runs.
WARM_STEPS = 3


def module(kind: str, name: str):
    """``gpubench.<kind>.<name>`` (``-`` as ``_``)."""
    return importlib.import_module(f"gpubench.{kind}.{name.replace('-', '_')}")


def load_cell(name: str, bench_path: Path, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration (the
    file it names, from the checkout), traffic and limits (from ``root``'s
    ``traffic/`` and ``workloads/``) and metrics."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    checkout = bench_path.parent
    checks = json.loads((root / "workloads" / f"{name}.json").read_text())
    return {"name": name, "chips": w["chips"],
            "config": json.loads((checkout / conf["file"]).read_text()),
            "traffic": json.loads(
                (root / "traffic" / f"{w['traffic']}.json").read_text()),
            "limits": checks["limits"],
            "reference_steps": checks.get("reference_steps", WARM_STEPS),
            "metrics": {k: bench[k] for k in ("end_to_end", "per_layer")}}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def draw_weights(layout, seed: int, device) -> dict:
    """The layout's weights, float32 on ``device``: every normal leaf cut
    from one seeded draw, zeros and ones as the layout says."""
    leaves = flat(layout)
    total = sum(math.prod(v.shape) for v in leaves.values()
                if v.init == "normal")
    gen = graphs.generator(seed, 3, device)
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for path, leaf in leaves.items():
        if not isinstance(leaf, Leaf):
            raise TypeError(f"{path}: not a layout leaf")
        if leaf.init == "normal":
            n = math.prod(leaf.shape)
            out[path] = noise[at:at + n].view(leaf.shape).mul_(leaf.std)
            at += n
        elif leaf.init == "zeros":
            out[path] = torch.zeros(leaf.shape, device=device)
        else:
            out[path] = torch.ones(leaf.shape, device=device)
    return unflat(layout, out)


def inputs(cell: dict, seed: int, device) -> dict:
    """The cell's inputs, by its traffic kind (:mod:`gpubench.kinds`)."""
    return module("kinds", cell["traffic"]["kind"]).inputs(cell, seed, device)


def program_batches(cell: dict, data: dict, prog_cell) -> list:
    """Each batch of the pool in the program's layout, on the device."""
    prog = module("program", cell["config"]["arch"])
    return module("kinds", cell["traffic"]["kind"]).program_batches(
        cell, data, prog, prog_cell)


# ---------------------------------------------------------------------------
# Faults planted under the timed path (the comparison must fail them)
# ---------------------------------------------------------------------------

def _half_batch(batch):
    """``batch`` with the later half of its loss's nodes masked out."""
    from dataclasses import replace

    mask = batch.nmask().clone()
    idx = torch.nonzero(mask).squeeze(1)
    mask[idx[idx.numel() // 2:]] = 0.0
    return replace(batch, node_mask=mask)


def planted(step, fault: str | None):
    """``step`` with ``fault``: ``"unchanged"`` returns the state it was
    given; ``"half_batch"`` takes the loss over half the batch's nodes."""
    if fault is None:
        return step
    if fault == "unchanged":
        def clone(tree):
            return unflat(tree, {k: v.clone() for k, v in flat(tree).items()})

        def unchanged(params, opt_state, batch):
            _, _, metrics = step(clone(params), type(opt_state)(
                *[clone(x) for x in opt_state]), batch)
            return params, opt_state, metrics
        return unchanged
    if fault == "half_batch":
        return lambda p, o, b: step(p, o, _half_batch(b))
    raise ValueError(f"unknown fault {fault!r}")


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def _checked(cell: dict) -> int:
    n = cell.get("reference_steps", WARM_STEPS)
    if not 1 <= n <= WARM_STEPS:
        raise ValueError(f"reference_steps {n} not in 1..{WARM_STEPS}")
    return n


def program_side(cell: dict, seed: int, device, *, fault=None) -> dict:
    """Inputs, weights, the program's cell and its warm steps, of which
    the first ``reference_steps`` are read: ``state`` (what the window
    goes on with), ``readings``, ``data`` and ``times`` (host seconds of
    each part, synchronised)."""
    from . import program

    conf = cell["config"]
    ref = module("reference", conf["arch"])
    times, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        sync(device)
        times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    data = inputs(cell, seed, device)
    lap("inputs")
    params = draw_weights(ref.layout(conf["model"]), seed, device)
    start = {k: v.detach().cpu().clone() for k, v in flat(params).items()}
    prog_cell = program.train_cell(conf["arch"], conf["shape"],
                                   conf["model"], params, device)
    lap("weights and cell")
    batches = program_batches(cell, data, prog_cell)
    lap("program batches")
    step = planted(prog_cell.step, fault)
    p, o = prog_cell.params, prog_cell.opt_state
    del prog_cell, params
    b1 = conf["optimizer"]["b1"]
    checked = _checked(cell)
    losses, grad, grad_t, delta = [], {}, {}, {}
    for t in range(WARM_STEPS):
        p, o, metrics = step(p, o, batches[t % len(batches)])
        losses.append(float(metrics["loss"]))
        lap(f"step {t + 1}")
        if t == 0:
            grad = {k: float(torch.linalg.vector_norm(v.float())) / (1 - b1)
                    for k, v in flat(o.mu).items()}
            grad_t = {k: v.detach().cpu().double() / (1 - b1)
                      for k, v in flat(o.mu).items()}
        if t + 1 == checked:
            delta = {k: float(torch.linalg.vector_norm(
                v.detach().float() - start[k].to(v.device)))
                for k, v in flat(p).items()}
    if not all(math.isfinite(x) for x in losses[checked:]):
        losses[checked - 1] = math.nan  # a later warm step failed
    losses = losses[:checked]
    return {"state": [p, o, step, batches], "data": data, "start": start,
            "readings": {"loss": losses, "grad": grad, "grad_t": grad_t,
                         "delta": delta},
            "times": times}


def reference_side(cell: dict, data: dict, start: dict, device, *,
                   dtype=torch.float64) -> dict:
    """The reference's readings of the checked steps from the same
    weights on the same (unpadded) batches, in ``dtype``."""
    conf = cell["config"]
    ref = module("reference", conf["arch"])
    layout = ref.layout(conf["model"])
    params = unflat(layout, {k: v.to(device=device, dtype=dtype)
                             for k, v in start.items()})
    n = len(data["pool"])
    kind = module("kinds", cell["traffic"]["kind"])
    batches = [kind.ref_batch(data, t % n, device)
               for t in range(_checked(cell))]

    def loss(p, b):
        return ref.loss(p, b, conf["model"])

    return adamw_steps(loss, params, batches, conf["optimizer"])


def window(state: list, seconds: float, device, first: int) -> dict:
    """Steps until ``seconds`` have passed on the host clock, each ended
    by a synchronise; the window is from the first step's launch to the
    last step's end."""
    p, o, step, batches = state
    losses, steps = [], 0
    t0 = time.perf_counter()
    while True:
        p, o, metrics = step(p, o, batches[(first + steps) % len(batches)])
        losses.append(metrics["loss"])
        sync(device)
        steps += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    state[0], state[1] = p, o
    finite = [math.isfinite(float(x)) for x in losses]
    return {"steps": steps, "window_s": elapsed,
            "failed": finite.count(False)}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, *,
        t_start: float, fault=None, say=print) -> dict:
    """One run; returns the record the metrics read, with ``correct``,
    ``numbers`` (what decided it) and, traced, the trace's summary."""
    conf = cell["config"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    side = program_side(cell, seed, dev, fault=fault)
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        prof = devtrace.profiler(dev.type == "cuda")
        prof.__enter__()
    win = window(side["state"], seconds, dev, WARM_STEPS)
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        dev_ev, host_ev = devtrace.events(prof)
        summary = devtrace.summarize(dev_ev, host_ev, win["window_s"])
        del prof, dev_ev, host_ev
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    data, start, prog = side["data"], side["start"], side["readings"]
    set_up = {k: round(v, 3) for k, v in side["times"].items()}
    del side
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_read = reference_side(cell, data, start, dev)
    ref_s = time.perf_counter() - t_ref
    numbers = check.compare(prog, ref_read)
    correct = check.judge(numbers, cell["limits"]) and win["failed"] == 0
    ref = module("reference", conf["arch"])
    sizes = data["sizes"]
    order = [sizes[(WARM_STEPS + i) % len(sizes)]
             for i in range(win["steps"])]
    norms = {side: {k: v for k, v in r.items() if k != "grad_t"}
             for side, r in (("program", prog), ("reference", ref_read))}
    say(f"set-up (host s): {json.dumps(set_up)}; inputs: "
        f"{json.dumps(data['stats'])}; reference {ref_s:.1f} s "
        f"(host clock); readings: {json.dumps(norms)}")
    return {**win, "setup_s": setup_s, "peak_bytes": peak,
            "chips": cell["chips"], "dtype": conf["dtype"],
            "nodes_per_step": data["nodes_per_step"],
            "flops_per_step": sum(ref.flops(conf["model"], n, e)
                                  for n, e in order) / win["steps"],
            "aggregate_bytes_per_step": sum(
                ref.aggregate_bytes(conf["model"], n, e)
                for n, e in order) / win["steps"],
            "trace": summary, "correct": correct, "numbers": numbers,
            "attempted": win["steps"] + WARM_STEPS}


def metrics(cell: dict, record: dict, trace: bool) -> dict:
    """The cell's metrics of this kind of run, each by its reader; a
    reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell["metrics"]["per_layer" if trace else "end_to_end"]:
        value = module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
