"""The program's spans and counters on the CPU at tiny sizes: which spans a
step runs in, the phase and block :mod:`gpubench.spans` gives each
operation, a reading of device events against its sums by hand, the
trace's reading of :mod:`gpubench.devtrace` unchanged by the spans, the
layout counters against the pool, and the new readers."""

import contextlib
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from gpubench import devtrace, harness, spans, spantrace
from gpubench.program import counters

from . import cells

BIG_SEED = 2 ** 31 + 2024
CELLS = {"gcn": cells.gcn, "equiformer": cells.equiformer}
#: The spans each tiny cell's step runs in.
SPANS = {"gcn": {"step", "step.forward", "step.backward", "step.update",
                 "mp.gather_rows", "mp.scatter", "mp.segment_sum",
                 "mp.sym_norm"},
         "equiformer": {"step", "step.forward", "step.backward",
                        "step.update", "remat.recompute", "mp.gather_rows",
                        "mp.segment_softmax", "mp.segment_sum", "eqv2.norm",
                        "eqv2.attention", "eqv2.so2_conv", "eqv2.gate_ffn"}}
SPAN_METRICS = ("aggregate_span_pct", "step_idle_pct", "optimizer_ms",
                "recompute_pct")
COUNTER_METRICS = ("pad_rows_pct", "layout_s")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _traced_step(arch, side=None):
    side = side or harness.program_side(CELLS[arch](), BIG_SEED, "cpu")
    p, o, step, batches = side["state"]
    with devtrace.profiler(cuda=False) as prof:
        side["state"][:2] = step(p, o, batches[0])[:2]
    return prof, side


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_a_step_runs_in_the_programs_spans(arch):
    prof, _ = _traced_step(arch)
    _, host, found = spans.collect(prof)
    assert {host[i].name for i in found} == SPANS[arch]
    # The gathers' backward sums in segment_sum's span.
    parent = devtrace._parents(host)
    inside = set()
    for i in found:
        if host[i].name == "mp.segment_sum":
            j = parent[i]
            while j >= 0 and not host[j].name.startswith(devtrace._EVALUATE):
                j = parent[j]
            if j >= 0:
                inside.add(host[j].name[len(devtrace._EVALUATE):])
    assert "_GatherRowsBackward" in inside


def test_the_two_cells_run_every_message_passing_span():
    assert {n for s in SPANS.values() for n in s if n.startswith("mp.")} == {
        "mp.segment_sum", "mp.gather_rows", "mp.segment_softmax",
        "mp.scatter", "mp.sym_norm"}


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_each_operation_gets_its_phase_and_block(arch):
    prof, _ = _traced_step(arch)
    _, host, found = spans.collect(prof)
    phase, block, _ = spans.attribute(host, found)
    nodes: dict = {}
    for i, h in enumerate(host):
        if h.name.startswith(devtrace._EVALUATE):
            node = h.name[len(devtrace._EVALUATE):]
            nodes.setdefault(node, set()).add(block[i])
            assert phase[i] == "step.backward", h.name
    mp = lambda b: b is not None and b.startswith("mp.")
    for node in ("IndexAddBackward0", "_GatherRowsBackward"):
        assert all(mp(b) for b in nodes[node]), (node, nodes[node])
    assert any(mp(b) for b in nodes["SliceBackward0"])
    assert not any(mp(b) for b in nodes["MmBackward0"])
    ops = [(phase[i], h.name) for i, h in enumerate(host) if i not in found]
    assert ("step.update", "aten::sqrt") in ops
    assert any(p == "step.forward" for p, _ in ops)
    assert any(p == "remat.recompute" for p, _ in ops) == (
        arch == "equiformer")


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_devtrace_reads_a_step_with_spans_as_one_without(arch, monkeypatch):
    with_spans, side = _traced_step(arch)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    without, _ = _traced_step(arch, side)
    assert spans.collect(without)[2] == set()
    reads = []
    for prof in (with_spans, without):
        dev, host = devtrace.events(prof)
        # The spans among the host events do not move a verdict.
        hosts = [devtrace.host_event(ev)
                 for ev in prof.profiler.kineto_results.events()
                 if ev.start_thread_id() == ev.end_thread_id()]
        under = devtrace.message_passing_ops(hosts)
        reads.append((dev, Counter(n for _, _, n in host),
                      Counter(h.name for h in hosts if h.corr in under
                              and h.name not in SPANS[arch]),
                      devtrace.summarize(dev, host, 1.0)))
    assert reads[0] == reads[1]
    assert not set(reads[0][1]) & SPANS[arch]


MS = 1_000_000


def _host(start, end, thread, name, seq=-1, fwd=0):
    return devtrace.Host(start * MS, end * MS, thread, name, False, 0, seq,
                         fwd, list)


def test_a_reading_of_device_events():
    """Main thread 1 runs the step; the engine's thread 2 runs a backward
    node for the forward's ``index_add_`` and a recompute."""
    host = [_host(0, 100, 1, "step"), _host(0, 40, 1, "step.forward"),
            _host(10, 30, 1, "mp.segment_sum"),
            _host(12, 20, 1, "aten::index_add_", seq=7),
            _host(40, 80, 1, "step.backward"),
            _host(45, 60, 2, devtrace._EVALUATE + "IndexAddBackward0",
                  seq=7, fwd=1),
            _host(50, 55, 2, "aten::index_select"),
            _host(62, 75, 2, "remat.recompute"),
            _host(64, 66, 2, "aten::mm"),
            _host(80, 100, 1, "step.update"),
            _host(85, 90, 1, "aten::_foreach_add_"),
            _host(200, 210, 1, "mp.gather_rows"),
            _host(201, 202, 1, "aten::index_select")]
    found = {i for i, h in enumerate(host) if spans._is_span(h.name)}
    # Each device event by the index of its launch (-1: none found).
    dev = [(15 * MS, 25 * MS, 3), (52 * MS, 58 * MS, 6),
           (65 * MS, 70 * MS, 8), (86 * MS, 95 * MS, 10),
           (120 * MS, 125 * MS, -1), (199 * MS, 205 * MS, 12)]
    r = spans.reading(dev, host, found, 0.3)
    got = {(p, b): s for p, blocks in r["device_s"].items()
           for b, s in blocks.items()}
    assert got == pytest.approx({
        ("step.forward", "mp.segment_sum"): 0.010,
        ("step.backward", "mp.segment_sum"): 0.006,
        ("remat.recompute", spans.NO_SPAN): 0.005,
        ("step.update", spans.NO_SPAN): 0.009,
        (spans.OUTSIDE, spans.NO_SPAN): 0.005,
        (spans.OUTSIDE, "mp.gather_rows"): 0.006})
    assert r["busy_s"] == pytest.approx(0.041)
    assert r["idle_s"] == pytest.approx({"step.forward": 0.027,
                                         "step.backward": 0.023,
                                         spans.OUTSIDE: 0.099})
    assert (r["steps"], r["early_kernels"]) == (1, 1)
    assert r["early_lead_s"] == pytest.approx(0.001)
    assert r["step_s"] == pytest.approx(0.1)
    assert r["step_idle_s"] == pytest.approx(0.07)
    record = {"trace": {}, "spans": r}
    read = lambda name: harness.module("metrics", name).read(record)
    assert read("aggregate_span_pct") == pytest.approx(100 * 22 / 41)
    assert read("step_idle_pct") == pytest.approx(70.0)
    assert read("optimizer_ms") == pytest.approx(9.0)
    assert read("recompute_pct") == pytest.approx(100 * 5 / 41)


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_new_readers_leave_out_what_they_cannot_read(name, monkeypatch):
    read = harness.module("metrics", name).read
    assert read({"trace": None}) is None
    empty = {"busy_s": 0.0, "window_s": 1.0, "device_s": {}, "idle_s": {},
             "steps": 0, "step_s": 0.0, "step_idle_s": 0.0,
             "early_kernels": 0, "early_lead_s": 0.0}
    counters.reset()
    assert read({"trace": {}, "spans": empty}) is None
    # A program that keeps no counters (one without repro_torch.obs).
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert counters.read() is None
    assert read({"trace": {}, "spans": empty}) is None


def test_the_layout_counters_count_the_pool():
    cell = cells.equiformer()
    counters.reset()
    side = harness.program_side(cell, BIG_SEED, "cpu")
    from repro_torch.launch import steps

    traffic = cell["traffic"]
    n_pad, e_pad = steps.sampled_subgraph_sizes(traffic["seeds"],
                                                tuple(traffic["fanout"]))
    stats, pool = side["data"]["stats"], traffic["pool"]
    c = counters.read()
    assert c["layout.batches"] == pool
    assert c["layout.node_rows"] == pool * n_pad
    assert c["layout.edge_rows"] == pool * e_pad
    assert c["layout.real_node_rows"] == sum(stats["sample_nodes"])
    assert c["layout.real_edge_rows"] == sum(stats["sample_edges"])
    read = lambda name: harness.module("metrics", name).read({"trace": {}})
    assert read("pad_rows_pct") == pytest.approx(
        100 * (1 - sum(stats["sample_nodes"]) / (pool * n_pad)), abs=1e-9)
    assert 0 < read("layout_s") * pool <= side["times"]["program batches"]
    # Full batches lay out nothing.
    counters.reset()
    harness.program_side(cells.gcn(), BIG_SEED, "cpu")
    assert read("pad_rows_pct") is None and read("layout_s") is None


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_spantrace_reads_a_traced_window(arch):
    rec = spantrace.traced(CELLS[arch](), BIG_SEED, 0.0, "cpu")
    json.dumps({k: rec[k] for k in ("spans", "counters", "stats", "times")})
    assert rec["spans"]["steps"] == rec["steps"] >= 1
    assert rec["spans"]["busy_s"] == 0.0  # no device events on the CPU
    got = {m: harness.module("metrics", m).read(rec)
           for m in spantrace.METRICS}
    assert (got["pad_rows_pct"] is not None) == (arch == "equiformer")
    assert got["aggregate_span_pct"] is None and got["recompute_pct"] is None
    assert any(line.startswith("idle s by span")
               for line in spans.table(rec["spans"]))


def test_spantrace_without_a_card_exits_2():
    checkout = Path(__file__).resolve().parents[2]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(checkout / "src"),
                                          str(checkout)])}
    out = subprocess.run(
        [sys.executable, str(checkout / "gpubench" / "spantrace.py"),
         "--workload", "gcn-products-fullbatch", "--seeds", "1",
         "--seconds", "1"], capture_output=True, text=True, timeout=120,
        cwd=checkout, env=env)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""


class _Event:
    """A kineto event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, dur, *, corr=0, link=0, cuda=False,
                 annotation=False, python=False):
        self._v = (name, start, dur, corr, link, cuda, annotation, python)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[5]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[6]

    def is_python_function(self):
        return self._v[7]

    def start_thread_id(self):
        return 1

    end_thread_id = start_thread_id

    def sequence_nr(self):
        return -1

    def fwd_thread_id(self):
        return 0

    def stack(self):
        return []


def test_kernels_go_to_their_operation_by_both_ids():
    """The runtime call of ``segment_sum``'s ``index_add_`` has the CUDA
    correlation id 7, the same number as the operation id of an
    ``aten::mm`` outside message passing: the product's kernel goes by
    its own runtime call (ids 5 and 7), and so to no block."""
    events = [
        _Event("aten::mm", 0, 100, corr=7),
        _Event("cudaLaunchKernel", 10, 5, corr=5, link=7),
        _Event("repro_torch/models/common.py(180): segment_sum", 200, 200,
               python=True),
        _Event("mp.segment_sum", 205, 145, corr=99, annotation=True),
        _Event("aten::index_add_", 210, 90, corr=100),
        _Event("cudaLaunchKernel", 220, 5, corr=7, link=100),
        _Event("sm90_xmma_gemm_f32f32", 1000, 1000, corr=5, link=7,
               cuda=True),
        _Event("indexFuncLargeIndex<double>", 2000, 500, corr=7, link=100,
               cuda=True)]
    prof = type("P", (), {"profiler": type("R", (), {"kineto_results": type(
        "K", (), {"events": staticmethod(lambda: events)})})})
    r = spans.read(prof, 1.0)
    assert r["device_s"] == {spans.OUTSIDE: pytest.approx(
        {spans.NO_SPAN: 1e-6, "mp.segment_sum": 5e-7})}
    kinds = spantrace.kinds_by_ops(prof, 1.5e-6)
    assert kinds["dense"] == pytest.approx(100 * 2 / 3)
    assert kinds["aggregate"] == pytest.approx(100 / 3)
