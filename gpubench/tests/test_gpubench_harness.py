"""The harness on the CPU at tiny sizes: a sound run is judged correct,
each fault planted under the timed path is not, a cell given only by data
files runs, and the metric readers and the trace's reading."""

import json
import time

import pytest
import torch

from gpubench import devtrace, harness
from gpubench.reference.common import flat

from . import cells

BIG_SEED = 2 ** 31 + 2024
CELLS = {"gcn": cells.gcn, "equiformer": cells.equiformer}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None, seed=BIG_SEED):
    return harness.run(cell, seed, 0.0, False, "cpu",
                       t_start=time.perf_counter(), fault=fault,
                       say=lambda msg: None)


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_sound_run_is_correct(arch):
    rec = _run(CELLS[arch]())
    assert rec["correct"], rec["numbers"]
    assert rec["steps"] >= 1 and rec["failed"] == 0
    assert rec["attempted"] == rec["steps"] + harness.WARM_STEPS
    assert rec["flops_per_step"] > 0 and rec["aggregate_bytes_per_step"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("arch", sorted(CELLS))
def test_planted_fault_is_not_correct(arch, fault):
    rec = _run(CELLS[arch](), fault=fault)
    assert not rec["correct"], rec["numbers"]


def test_program_weights_match_the_programs_layout():
    from repro_torch.launch import steps
    from repro_torch.params import gnn_params

    for make in CELLS.values():
        conf = make()["config"]
        ref = harness.module("reference", conf["arch"])
        ours = flat(harness.draw_weights(ref.layout(conf["model"]), 1, "cpu"))
        from dataclasses import replace
        cfg = replace(steps.gnn_config(conf["arch"], conf["shape"]),
                      **conf["model"])
        theirs = flat(gnn_params(cfg, 0))
        assert {k: tuple(v.shape) for k, v in ours.items()} == {
            k: tuple(v.shape) for k, v in theirs.items()}


def test_a_cell_given_only_by_data_files_runs(tmp_path):
    cell = cells.gcn()
    root = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(cell["config"]))
    (root / "traffic" / "tiny_full.json").write_text(
        json.dumps(cell["traffic"]))
    (root / "workloads" / "tiny-cell.json").write_text(
        json.dumps({"limits": cell["limits"]}))
    bench = {"configs": [{"name": "tiny", "file": "gpubench/configs/tiny.json"}],
             "workloads": [{"name": "tiny-cell", "config": "tiny",
                            "traffic": "tiny_full", "chips": 1}],
             "end_to_end": [{"name": "train_nodes_per_s", "unit": "nodes/s"}],
             "per_layer": [{"name": "idle_pct", "unit": "%"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = harness.load_cell("tiny-cell", tmp_path / "BENCHMARK.json",
                               root=root)
    rec = _run(loaded)
    assert rec["correct"]
    got = harness.metrics(loaded, rec, trace=False)
    assert set(got) == {"train_nodes_per_s"} and got[
        "train_nodes_per_s"]["value"] > 0
    # The untraced run has no trace: the per-layer reader finds nothing.
    assert harness.metrics(loaded, rec, trace=True) == {}


def test_readers_leave_out_what_they_cannot_read():
    record = {"steps": 4, "window_s": 2.0, "setup_s": 9.5,
              "nodes_per_step": 100, "peak_bytes": 3 * 2 ** 30, "chips": 1,
              "flops_per_step": 6.7e12, "aggregate_bytes_per_step": 3.35e9,
              "dtype": "float32", "trace": None}
    read = lambda name: harness.module("metrics", name).read(record)
    assert read("train_nodes_per_s") == 200.0
    assert read("peak_mem_gib") == 3.0 and read("setup_s") == 9.5
    for name in ("mfu_pct", "aggregate_roofline_pct", "aggregate_share_pct",
                 "dense_share_pct", "idle_pct"):
        assert read(name) is None
    record["trace"] = {"busy_s": 1.5, "window_s": 2.0,
                       "kinds": {"aggregate": 0.5, "dense": 0.25}}
    assert read("mfu_pct") == pytest.approx(20.0)
    assert read("aggregate_roofline_pct") == pytest.approx(0.8)
    assert read("aggregate_share_pct") == pytest.approx(100 / 3)
    assert read("dense_share_pct") == pytest.approx(100 / 6)
    assert read("idle_pct") == pytest.approx(25.0)
    record["peak_bytes"] = None
    assert read("peak_mem_gib") is None


def test_trace_summary():
    ms = 1_000_000
    dev = [(0, 10 * ms, "void at::native::indexFuncLargeIndex<double>", True),
           (5 * ms, 12 * ms, "sm90_xmma_gemm_f32f32_f32f32_f32_tn", False),
           (20 * ms, 30 * ms, "Memcpy DtoH (Device -> Pageable)", False),
           (40 * ms, 41 * ms, "ncclDevKernel_AllReduce_Sum_f32", True),
           (41 * ms, 43 * ms, "elementwise_kernel<FillFunctor>", True),
           (43 * ms, 45 * ms, "vectorized_gather_kernel", False)]
    host = [(11 * ms, 25 * ms, "aten::item"), (13 * ms, 19 * ms,
                                               "aten::_local_scalar_dense"),
            (30 * ms, 50 * ms, "ProfilerStep")]
    s = devtrace.summarize(dev, host, 0.05)
    assert s["busy_s"] == pytest.approx(0.027)
    # The layer goes by the launching operation, not the kernel's name.
    assert s["kinds"] == pytest.approx({"aggregate": 0.012, "dense": 0.007,
                                        "copies": 0.010, "nccl": 0.001,
                                        "other": 0.002})
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"aten::_local_scalar_dense": 0.008,
                                  "ProfilerStep": 0.010})
    assert s["breakdown"]["device_ops"][0][1] == pytest.approx(0.010)


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_message_passing_is_found_in_the_forward_and_the_backward(arch):
    side = harness.program_side(CELLS[arch](), BIG_SEED, "cpu")
    p, o, step, batches = side["state"]
    with devtrace.profiler(cuda=False) as prof:
        step(p, o, batches[0])
    host = [devtrace.host_event(ev)
            for ev in prof.profiler.kineto_results.events()
            if ev.start_thread_id() == ev.end_thread_id()]
    under = devtrace.message_passing_ops(host)
    parent = devtrace._parents(host)
    names = {}
    for i, h in enumerate(host):
        if h.name.startswith(devtrace._EVALUATE):
            node = h.name[len(devtrace._EVALUATE):]
            names.setdefault(node, set()).add(h.corr in under)
        elif h.name == "aten::index_add_" and (
                h.stack() or host[parent[i]].python):
            names.setdefault(h.name, set()).add(h.corr in under)
    # The scatters, their chunks' slices and casts and their backward.
    assert names["aten::index_add_"] == {True}
    assert names["IndexAddBackward0"] == {True}
    assert names["_GatherRowsBackward"] == {True}
    assert True in names["SliceBackward0"] and True in names[
        "ToCopyBackward0"]
    # The dense products and the loss are not message passing.
    assert names["MmBackward0"] == {False}
    assert names["LogsumexpBackward0" if arch == "gcn" else "MeanBackward0"
                 ] == {False}
    # Within a backward node, every operation is put where its node is.
    for i, h in enumerate(host):
        j = parent[i]
        while j >= 0 and not host[j].name.startswith(devtrace._EVALUATE):
            j = parent[j]
        if (j >= 0 and h.corr > 0 and not h.python and not any(
                host[k].python or host[k].stack()
                for k in _chain(parent, i, j))):
            assert (h.corr in under) == (host[j].corr in under), h.name


def test_message_passing_is_found_from_the_operations_stacks():
    """Where the profiler gives Python frames only as each operation's
    stack (every operation the whole stack of its thread, as torch 2.11
    does) and not as events of their own, the same operations are
    found."""
    side = harness.program_side(cells.gcn(), BIG_SEED, "cpu")
    p, o, step, batches = side["state"]
    with devtrace.profiler(cuda=False) as prof:
        step(p, o, batches[0])
    host = [devtrace.host_event(ev)
            for ev in prof.profiler.kineto_results.events()
            if ev.start_thread_id() == ev.end_thread_id()]
    parent = devtrace._parents(host)
    as_stacks = []
    for i, h in enumerate(host):
        if h.python:
            continue
        frames, j = [], parent[i]
        while j >= 0:
            if host[j].python:
                frames.append(host[j].name)
            j = parent[j]
        as_stacks.append(h._replace(stack=lambda f=tuple(frames): list(f)))
    assert any(h.stack() for h in as_stacks)
    assert (devtrace.message_passing_ops(as_stacks)
            == devtrace.message_passing_ops(host))


def test_grad_diff_sees_rounding_that_a_gap_of_norms_cancels():
    from gpubench import check

    gen = torch.Generator().manual_seed(0)
    ref_t = {"w": torch.randn(100, 16, generator=gen, dtype=torch.float64),
             "b": torch.randn(16, generator=gen, dtype=torch.float64)}
    noise = torch.randn(100, 16, generator=gen, dtype=torch.float64) * 1e-3
    prog_t = {"w": ref_t["w"] * (1 + noise), "b": ref_t["b"].clone()}
    side = lambda t: {"loss": [1.0], "grad_t": t, "delta": {"w": 1, "b": 1},
                      "grad": {k: float(torch.linalg.vector_norm(v))
                               for k, v in t.items()}}
    numbers = check.compare(side(prog_t), side(ref_t))
    assert numbers["grad"][0] < 1e-4
    assert 5e-4 < numbers["grad_diff"][0] < 2e-3
    assert numbers["grad_diff"][1] == "w"
    assert check.judge(numbers, {"grad": 1e-4})
    assert not check.judge(numbers, {"grad": 1e-4, "grad_diff": 1e-4})


def _chain(parent, i, top):
    while i != top:
        yield i
        i = parent[i]


@pytest.mark.parametrize("steps", [1, 2])
def test_the_reference_may_follow_fewer_steps(steps):
    cell = {**cells.gcn(), "reference_steps": steps}
    side = harness.program_side(cell, BIG_SEED, "cpu")
    assert len(side["readings"]["loss"]) == steps
    ref = harness.reference_side(cell, side["data"], side["start"], "cpu")
    assert len(ref["loss"]) == steps
    assert side["readings"]["delta"].keys() == ref["delta"].keys()
    rec = _run(cell)
    assert rec["correct"], rec["numbers"]
