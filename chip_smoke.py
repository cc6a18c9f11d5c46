#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; without a card it exits 1 and prints no
result.  Phases, any failure of which ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles the kernels under ``src/repro_torch/csrc``; the
   registers and spills of each instance of the tensor-core kernels, by
   name: bf16 K5 and K1 / K2, and of K3 and K4 (none may spill);
3. kernels vs plain versions: K1 (fused), K2 (aggregate) and K3 (combine)
   on the card, f32 and bf16, at the reference's four kernel-test shapes,
   at two shapes of the cluster schedules (one feature chunk split over 4
   ranks by source blocks; 6 feature chunks) and at the two full-width
   GCN-Cora layers (seeded Cora-sized graph, GCN weights in the reference
   layout), against their plain PyTorch versions;
4. the GNN layer path: the launch counters are zeroed, then the 2-layer
   GCN-Cora forward runs fused and unfused through ``repro_torch.kernels.
   ops``, and the conformance harness holds the kernels' byte schedules to
   their closed forms at all twelve operating points and runs them against
   the fp32 oracle; the counters are read right after, and every layer
   kernel must have launched;
5. times at each Cora layer (CUDA events around one call queued behind a
   device-side sleep, median of 20, warm L2): each kernel
   beside its bound, its plain version and one PyTorch library call that
   computes the same function (timed here only; the port never calls it);
   K1 and K2 also beside their block-dense bound (the schedule's operations
   at the rate of the arithmetic they use, or its traced bytes), K1 beside
   the same-association ``matmul(matmul(A, X), W)``; K1-K3's grids and how
   many of their clusters fit the card at once, and K3's share of its byte
   bound; bf16 K1 and K2 at layer 1; and the fused-minus-unfused time (K2 +
   K3 - K1) against the modelled spill;
6. K4 (the trace segment reduce) against its plain version, bit for bit:
   every trace dataset at the reference test battery's parameters and
   capacities, an int64-index case, a 2^53-scale multiplicity case, the
   boundaries of K4's routes (one tile, the last tile count the shared
   histogram holds and one more, packed and unpacked; 65,536 tiles; the
   packing limit 2^32), and the 10^7-edge graph of phase 7 at all 16
   capacities; each case passes its multiplicities' total, as a trace does,
   or none, and both routes of each kind must occur;
7. the exact-trace path: the counters are zeroed, then
   ``examples/scenarios/trace_smoke.json`` runs through the scenario front
   door (its three pins must hold), and ``TiledGraphModel`` sweeps 16 tile
   capacities of a 10^7-edge power-law graph (V = 10^6) for ``engn``,
   ``hygcn``, ``awb_gcn`` and a GCN-Cora-width ``engn`` stack, plus the
   10^6-edge graph's sweep; the counters are read right after.  Every
   schedule and every term must equal the NumPy engine's bit for bit, and
   the 10^6-edge schedules the per-capacity ``np.unique`` oracle's;
8. times of K4 per capacity of the 10^7-edge sweep (CUDA events, median of
   20) beside its byte bound and its share of it, its route, its plain
   version and ``index_add_``, and the host-clock times of the
   factorization and of the whole sweep under each engine;
9. K5 (flash attention) against its plain version, f32 and bf16: the
   reference test grid, GQA at rep 3 (SmolLM's) and rep 4, softcap 50
   (gemma2's), head dims 16-256, s < 128, and the serving path's own shape
   (B = 8, S = 1920, H = 9, Hk = 3, D = 64), all through the counted
   wrapper; bf16 cases are also held element by element to one bf16 step;
10. the serving path: SmolLM-135M at full width and depth (30 layers,
   d 576), bf16, seeded weights.  The counters are zeroed, then one prefill
   of 8 prompts of 1920 seeded tokens (``max_seq`` 2048, the published
   context) and 128 greedy decode steps run through ``make_prefill_step``
   and ``make_serve_step``; the counters are read right after, and K5 must
   have launched exactly 30 times.  In f32 at B = 2, S = 256 the prefill on
   the card matches the same prefill on the CPU (plain versions, the same
   weights moved over by ``.cpu()``) and 256 decode steps from an empty
   cache, and 4 further decode steps from each cache agree, all to 1e-4;
11. K5's time at the serving shape (CUDA events, median of 20), its
   TFLOP/s and share of its bound, beside the bound, its plain version,
   ``scaled_dot_product_attention`` (timed here only; the port never calls
   it) and the f32 CUDA-core K5 on the same inputs widened to f32, and its
   share of one prefill; K5 at gemma2-2b's attention shape (B 2, S 4096,
   H 8, Hk 4, D 256, softcap 50), beside its bound and plain version; the
   device time of one prefill and of 8 decode steps by kind (K5, cuBLAS
   products, other kernels) under ``torch.profiler``, against the
   unprofiled host time, which gives the device's idle share;
12. K6 (the embedding bag) against its plain version, bit for bit, f32 and
   bf16, through the counted wrapper: the reference test grid, D not a
   multiple of 8, bags of 37 and 64 ids, a 20,000,000-row table with ids
   past 2^24 (int64 row offsets), ids as strided slices of a (B, 26, hot)
   tensor written into strided output slots, and both serving batches at
   hot 1; f32 also against ``embedding_bag_ref`` (take, then sum) at 1e-6;
13. the DLRM serving path: DLRM-MLPerf at its published widths with the
   five 40M-row tables cut to 20M rows (``DLRM_ROW_CAP``; 53.34 GB of f32
   tables drawn on the card from a seed).  The counters are zeroed, then
   200 ``serve_p99`` requests (B = 512) and 5 ``serve_bulk`` batches
   (B = 262,144) of seeded Criteo batches go through ``dlrm.serve`` (copy
   in, forward, logits back), and one ``retrieval_cand`` call scores 10^6
   candidates; the counters are read right after, and K6 must have launched
   exactly 26 times per forward.  The last ``serve_bulk`` logits equal the
   same forward with the plain embedding bag bit for bit; at every table
   capped at 65,536 rows the f32 logits on the card match the CPU's to 1e-4
   (B = 512), and the retrieval scores match the CPU's to 1e-5;
14. K6's time per table at both serving batches (CUDA events, median of 20)
   beside its byte bound (the distinct rows the batch reads, its ids and
   its output), its plain version and ``torch.nn.functional.embedding_bag``
   (timed here only; the port never calls it); the device time of one
   ``serve_bulk`` request and of 8 ``serve_p99`` requests by kind (K6,
   cuBLAS products, copies, other kernels) under ``torch.profiler``,
   against their unprofiled host time.

The last three lines of standard output are the ``kernels`` JSON line, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: f32 against the fp32 plain versions (sums in another order); bf16 allows
#: one bf16 rounding of the output (and of the spilled aggregate).
TOLERANCE = {"f32": 1e-5, "bf16": 3e-2}
#: The reference's fused-kernel test shapes (n, f, t, block_n, block_k).
TEST_SHAPES = ((256, 32, 8, 128, 128), (512, 64, 16, 128, 256),
               (512, 128, 32, 256, 256), (1024, 16, 7, 256, 512))
#: Two shapes of the cluster schedules: one feature chunk whose 16 source
#: blocks split over 4 ranks (32 destination blocks), and 6 feature chunks,
#: not a power of two (in bf16 X's 1400-byte rows start off 16-byte
#: boundaries).
CLUSTER_SHAPES = ((2048, 24, 5, 64, 128), (1024, 700, 9, 64, 128))
#: Published H100 SXM peaks at 700 W: HBM bytes/s, fp32 (non-tensor) op/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: Published H100 SXM TF32 dense tensor-core peak at 700 W; K1 and K2 take
#: three TF32 products per f32 product (3xTF32).
PEAK_TF32_OPS_PER_S = 495e12
#: K4's integer operations per pair: two divisions (each a multiply and a
#: shift in the kernel), three compares, the flag or, and two adds.  They are set against the fp32 non-tensor peak:
#: the table has no integer rate outside the tensor cores, and the bound is
#: bytes by a factor of about 40 either way.
K4_OPS_PER_PAIR = 8
#: The reference trace battery's datasets and parameters
#: (tests/test_trace_engine.py), without the sharded build.
TRACE_DATASETS = {
    "power_law": {"n_nodes": 1200, "n_edges": 9000, "seed": 1, "alpha": 1.5},
    "power_law_stream": {"n_nodes": 1200, "n_edges": 9000, "seed": 1,
                         "alpha": 1.5},
    "cora": {},
    "molecule": {"batch": 16, "n_nodes": 12, "n_edges": 30},
    "ring_of_tiles": {"n_nodes": 512, "n_tiles": 8},
}
#: The largest single-host case of benchmarks/trace_scale.py, and the
#: 10^6-edge case its per-capacity reference still runs on.
BIG_TRACE = {"n_nodes": 1_000_000, "n_edges": 10_000_000, "seed": 0,
             "alpha": 1.6}
MID_TRACE = {"n_nodes": 100_000, "n_edges": 1_000_000, "seed": 0,
             "alpha": 1.6}
SWEEP_POINTS = 16
TRACE_SMOKE = (Path(__file__).resolve().parent / "examples" / "scenarios"
               / "trace_smoke.json")
TRACE_SMOKE_PINS = (5631360.0, 3763936.0, 898720.0)
TRACE_DATAFLOWS = ("engn", "hygcn", "awb_gcn")
LAYER_KERNELS = ("edge_aggregate", "edge_aggregate_unfused.aggregate",
                 "edge_aggregate_unfused.combine")
KERNELS = {
    "edge_aggregate": {
        "source": "src/repro_torch/csrc/edge_aggregate.cu",
        "replaces": "src/repro/kernels/edge_aggregate.py:48"},
    "edge_aggregate_unfused.aggregate": {
        "source": "src/repro_torch/csrc/edge_aggregate_unfused.cu",
        "replaces": "src/repro/kernels/edge_aggregate_unfused.py:36"},
    "edge_aggregate_unfused.combine": {
        "source": "src/repro_torch/csrc/edge_aggregate_unfused.cu",
        "replaces": "src/repro/kernels/edge_aggregate_unfused.py:52"},
    "segment_reduce.schedule_counts": {
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:102"},
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention_hopper.cuh",
        "replaces": "src/repro/kernels/flash_attention.py:30"},
    "embedding_bag": {
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:22"},
}
#: K5 against its plain version: the reference's tolerances
#: (tests/test_kernels.py), relative to the largest output.
ATTN_TOLERANCE = {"f32": 2e-5, "bf16": 3e-2}
#: One bf16 step relative to the value: 7 stored significand bits.
BF16_STEP = 2.0 ** -7
#: K5's cases (b, s, h, hk, d, block, causal, window, softcap): the
#: reference test grid (tests/test_kernels.py:84-99, block_q = block_k
#: here), GQA at rep 3 and rep 4, softcap 50, gemma2's head dim 256, s < 128,
#: an odd head dim with a ragged last q block, and a non-causal window.
ATTN_CASES = (
    (2, 128, 2, 2, 64, 64, True, None, None),
    (2, 256, 2, 2, 64, 128, True, None, None),
    (2, 256, 2, 2, 32, 64, True, 64, None),
    (2, 512, 2, 2, 128, 128, True, 128, None),
    (2, 128, 9, 3, 64, 64, True, None, None),
    (2, 128, 8, 2, 32, 64, True, None, None),
    (1, 128, 2, 2, 32, 64, True, None, 50.0),
    (1, 512, 8, 4, 256, 128, True, 200, 50.0),
    (2, 48, 3, 1, 16, 48, True, None, None),
    (2, 96, 4, 2, 48, 96, True, 40, None),
    (2, 128, 4, 2, 32, 64, False, 40, None),
)
#: The serving path: SmolLM-135M, 8 prompts of 1920 tokens, the published
#: 2048-token context, 128 greedy decode steps; the f32 checks at B = 2,
#: S = 256 with 4 further steps.
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_STEPS = 8, 1920, 2048, 128
CHECK_BATCH, CHECK_PROMPT, CHECK_MORE = 2, 256, 4
PROFILED_STEPS = 8
SERVE_TOLERANCE = 1e-4
#: Published H100 SXM bf16 dense tensor-core peak at 700 W.
PEAK_BF16_OPS_PER_S = 989e12
#: gemma2-2b's attention (src/repro/configs/gemma2_2b.py:16-19: 8 heads, 4
#: kv heads, head dim 256, softcap 50) over a 4096-token causal prefill
#: (its local window is 4096) at B = 2: (b, s, h, hk, d, softcap).
GEMMA2_ATTENTION = (2, 4096, 8, 4, 256, 50.0)
#: K6's cases (v, d, b, hot): the reference test grid
#: (tests/test_kernels.py:148-152), D = 100 (f32 vector loads, bf16 single
#: loads) and D = 30 (single loads in both), bags of 37 (tails of the
#: four-row and 32-id steps) and 64 ids.
BAG_CASES = ((128, 64, 8, 1), (1000, 128, 32, 4), (4096, 256, 16, 8),
             (1000, 100, 32, 4), (777, 30, 16, 3), (5000, 96, 24, 37),
             (5000, 128, 64, 64))
#: K6 in f32 against take-then-sum: the reference test's tolerance.
BAG_REF_TOLERANCE = 1e-6
#: The DLRM cut.  The published Criteo-1TB tables hold 204,184,588 rows,
#: 104.54 GB in f32, more than the card's 80 GB; bf16 tables would change
#: K6's numbers (it adds in the table's dtype).  So each of the five
#: 40,000,000-row tables (features 0, 9, 19, 20, 21) is cut to 20,000,000
#: rows, and the other 21 stay whole: 104,184,588 rows, 53.34 GB.  That is
#: this card's half of each big table in a 2-way row-sharded deployment (the
#: reference's param_pspecs layout), with the ids drawn from the slice.
#: serve_bulk's unchunked activations need about 12 GB beside the tables
#: (DLRM_ACTIVATION_BYTES), and 20M is the largest cap in steps of 5M that
#: leaves at least 10 GB of the card free; 25M would need 66.1 + 12 GB.
#: reduced: vocab_sizes (the five 40M-row tables, 40,000,000 -> 20,000,000).
DLRM_ROW_CAP = 20_000_000
DLRM_ACTIVATION_BYTES = 12e9
SERVE_P99_REQUESTS, SERVE_BULK_BATCHES, PROFILED_REQUESTS = 200, 5, 8
#: The f32 card-versus-CPU check: full widths, every table capped at
#: 65,536 rows (0.34 GB, small enough to copy to the CPU), B = 512.  1e-4
#: is the repo's model tolerance (TF32 products would fail it by about
#: 10x); a gather at hot 1 is exact, so none of it is spent on K6.
DLRM_CHECK_ROW_CAP, DLRM_CHECK_BATCH = 65_536, 512
DLRM_TOLERANCE = 1e-4
#: Retrieval scores, card vs CPU: one 128-long f32 dot per candidate.
RETRIEVAL_TOLERANCE = 1e-5


def k5_work(b: int, s: int, h: int, hk: int, d: int) -> tuple[int, int]:
    """Bytes and operations of one causal bf16 K5 call: q, k, v read once
    and o written once; the causal triangle's q·k and p·v."""
    return 2 * b * s * d * (2 * h + 2 * hk), 2 * d * s * (s + 1) * b * h


def ptxas_rows(log: str, pattern: str, name) -> list[str]:
    """Registers and spills of each kernel instance whose mangled name
    matches ``pattern``, from the ``-Xptxas -v`` log, named by
    ``name(match)``."""
    rows, entry, spill = [], None, ""
    for line in log.splitlines():
        found = re.search(pattern, line)
        if "Compiling entry function" in line:
            entry = name(found) if found else None
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            rows.append(f"{entry}: {int(line.split('Used')[1].split()[0])} "
                        f"registers; {spill}")
            entry = None
    return rows


def k5_ptxas(log: str) -> list[str]:
    """The bf16 K5 kernel's instances (``flash_wgmma_kernel<DP, KT>``); the
    registers are the count at launch, before ``setmaxnreg`` moves the
    producer's to the consumers."""
    return ptxas_rows(log, r"flash_wgmma_kernelILi(\d+)ELi(\d+)E",
                      lambda m: f"flash_wgmma_kernel<{m[1]}, {m[2]}>")


def aggregate_ptxas(log: str) -> list[str]:
    """K1's (fused) and K2's instances (``aggregate_kernel<T, BN, Fused>``)."""
    return ptxas_rows(
        log, r"aggregate_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
        lambda m: (f"aggregate_kernel<{'f32' if m[1] == 'f' else 'bf16'}, "
                   f"{m[2]}, {'K1' if m[3] == '1' else 'K2'}>"))


def combine_ptxas(log: str) -> list[str]:
    """K3's instances (``combine_kernel<T, BN, TB, W>``: block height, output
    columns a pass, warps)."""
    return ptxas_rows(
        log, r"combine_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
        lambda m: (f"combine_kernel<{'f32' if m[1] == 'f' else 'bf16'}, "
                   f"{m[2]}, {m[3]}, {m[4]}>"))


def k4_ptxas(log: str) -> list[str]:
    """K4's instances (``schedule_counts_kernel<I, Packed, Shared>``) and its
    unpacking pass."""
    return ptxas_rows(
        log, r"(schedule_counts_kernelI([il])Lb([01])ELb([01])E|unpack_kernel)",
        lambda m: ("unpack_kernel" if m[1] == "unpack_kernel" else
                   f"schedule_counts_kernel<int{32 if m[2] == 'i' else 64}, "
                   f"{'packed' if m[3] == '1' else 'unpacked'}, "
                   f"{'shared' if m[4] == '1' else 'global'}>"))


def cluster_fit(build, ea, eu, kname: str, pt) -> str:
    """K1's, K2's or K3's grid at an operating point (f32) and how many of
    its clusters fit on the card at once (``cudaOccupancyMaxActiveClusters``)."""
    fc = ea.feature_chunk(pt.Bn)
    if kname == "edge_aggregate":
        sched = ea.fused_grid_spec(pt.K, pt.N, pt.T, pt.Bn, pt.Bk)
        fit = build.library("edge_aggregate").fused_active_clusters(
            pt.K, pt.N, pt.T, pt.Bn, pt.Bk, fc, 0)
    elif kname == "edge_aggregate_unfused.combine":
        sched = eu.combine_grid_spec(pt.K, pt.N, pt.T, pt.Bn)
        fit = build.library("edge_aggregate_unfused").combine_active_clusters(
            pt.K, pt.N, pt.T, pt.Bn, fc, 0)
    else:
        sched = eu.aggregate_grid_spec(pt.K, pt.N, pt.Bn, pt.Bk)
        fit = build.library("edge_aggregate_unfused").aggregate_active_clusters(
            pt.K, pt.N, pt.Bn, pt.Bk, fc, 0)
    if fit < 0:
        raise RuntimeError(f"{kname}: cudaOccupancyMaxActiveClusters failed "
                           f"with CUDA error {-fit}")
    ranks, blocks = sched.grid
    return (f"grid {ranks} x {blocks} in {ranks * blocks // sched.cluster} "
            f"clusters of {sched.cluster}, {fit} fit on the card at once")


def dense_bound(conformance, ea, eu, kname: str, pt, dtype: str) -> str:
    """K1's or K2's block-dense bound at one operating point: the larger of
    the schedule's operations at the rate of the arithmetic the kernel uses
    (f32: three TF32 products at the TF32 rate, K1's combine at the fp32
    rate; bf16: the bf16 rate) and its traced bytes at the HBM rate."""
    K, F, T = pt.K, pt.N, pt.T
    elem = 4 if dtype == "f32" else 2
    fused = kname == "edge_aggregate"
    acct = (ea.fused_block_streams(K, F, T, block_n=pt.Bn, block_k=pt.Bk,
                                   elem_bytes=elem) if fused
            else eu.aggregate_block_streams(K, F, block_n=pt.Bn,
                                            block_k=pt.Bk, elem_bytes=elem))
    traced = conformance.block_schedule(acct["schedule"], acct["streams"])
    nbytes = sum(v["bytes"] for v in traced.values())
    ops = 2 * K * K * F
    ops_ms = 1e3 * (3 * ops / PEAK_TF32_OPS_PER_S if dtype == "f32"
                    else ops / PEAK_BF16_OPS_PER_S)
    if fused:
        ops_ms += 1e3 * 2 * K * F * T / PEAK_F32_OPS_PER_S
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    by = "operations" if ops_ms >= bytes_ms else "traced bytes"
    return f"{max(ops_ms, bytes_ms):.4f} ms ({by}: {ops_ms:.4f} ms of " \
           f"operations, {bytes_ms:.4f} ms of {nbytes:.0f} traced B)"


def rel_err(out, expect) -> float:
    out, expect = out.float(), expect.float()
    return float((out - expect).abs().max() / (expect.abs().max() + 1e-9))


def abs_err(out, expect) -> float:
    return float((out.float() - expect.float()).abs().max())


def beyond_bf16_step(out, expect) -> int:
    """Elements of a bf16 ``out`` farther from ``expect`` than one bf16 step
    of the value plus the f32 tolerance of the largest output: two fp32
    results that agree to the f32 tolerance, each rounded once to bf16,
    are never farther apart."""
    ref_abs = expect.float().abs()
    allowed = (BF16_STEP * ref_abs
               + ATTN_TOLERANCE["f32"] * float(ref_abs.max()))
    return int(((out.float() - expect.float()).abs() > allowed).sum())


#: Device-side sleep queued before each timed call, in clock cycles (about
#: 2.5 ms): the host enqueues the call while the card sleeps, so the events
#: time the card's work and not the host's launch overhead.
SLEEP_CYCLES = 5_000_000


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def pow2_caps(n_nodes: int, points: int) -> list[int]:
    """benchmarks/trace_scale.py's sweep: n_nodes/2, n_nodes/4, ...,
    ``points`` distinct capacities."""
    caps: list[int] = []
    i = 1
    while len(caps) < points:
        cap = max(1, n_nodes >> i)
        if caps and cap == caps[-1]:
            break
        caps.append(cap)
        i += 1
    return caps


def battery_caps(n_nodes: int) -> list[int]:
    """The reference trace battery's capacities (tests/test_trace_engine.py)."""
    return sorted({max(1, n_nodes >> i) for i in range(1, 11, 2)} | {n_nodes})


def pair_tensors(trace, dev) -> tuple:
    """A trace's factorization as K4's operands on ``dev``."""
    u_snd, u_rcv, u_new_src, mp = trace._pair_factorization()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (u_snd, u_rcv, u_new_src, np.diff(mp)))


def hot_pair_case(total: int) -> tuple:
    """tests/test_trace_engine.py's 2^53 case: 96 vertices, int64 pairs, one
    pair carrying nearly all of ``total`` edges."""
    V = 96
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, V * V, size=4 * V))
    u_snd, u_rcv = keys // V, keys % V
    mult = np.ones(u_snd.size, dtype=np.int64)
    mult[u_snd.size // 3] = total - (u_snd.size - 1)
    new_src = np.concatenate([[True], u_snd[1:] != u_snd[:-1]])
    return V, (u_snd, u_rcv, new_src, mult)


#: K4's route boundaries (n_tiles, total multiplicity or None) on
#: ``route_pairs``: one tile; 8192 packed or 4096 unpacked bins fill the
#: 64 KB shared histogram, one more goes to device memory; 65,536 tiles;
#: totals either side of the 2^32 packing limit.
K4_ROUTE_CASES = ((1, 10**6), (8192, 10**6), (8193, 10**6), (4096, None),
                  (4097, None), (65_536, 10**6), (65_536, None),
                  (4096, 2**32 - 1), (4096, 2**32), (3, 2**53 + 4097))


def route_pairs(seed: int = 5, V: int = 1 << 18, U: int = 200_000) -> tuple:
    """Seeded unique (sender, receiver) pairs over V vertices, sender-major,
    with multiplicities 1-3: the inputs of the route-boundary cases."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, V * V, U, dtype=np.int64))
    snd, rcv = (keys // V).astype(np.int32), (keys % V).astype(np.int32)
    new_src = np.concatenate([[True], snd[1:] != snd[:-1]])
    return V, (snd, rcv, new_src,
               rng.integers(1, 4, snd.size).astype(np.int64))


def trace_models(trace, caps, device) -> dict:
    """The sweep of phase 7: three dataflows at N = 30, T = 5 and EnGN at
    the GCN-Cora widths, over the capacity axis of one trace."""
    from repro_torch.core.compose import MultiLayerModel, TiledGraphModel

    tv = np.asarray(caps, dtype=np.float64)
    models = {name: TiledGraphModel(name, tile_vertices=tv, trace=trace,
                                    device=device)
              for name in TRACE_DATAFLOWS}
    models["engn_gcn_cora"] = TiledGraphModel(
        MultiLayerModel("engn", (1433.0, 16.0, 7.0)), tile_vertices=tv,
        trace=trace, device=device)
    return models


def same_schedules(got, expect, label: str) -> None:
    for g, e in zip(got, expect, strict=True):
        for key, value in e.counts_dict().items():
            if not np.array_equal(g.counts_dict()[key], value):
                raise AssertionError(f"{label}: cap={e.capacity} {key} "
                                     "differs")


def trace_phases(dev, card: str, launches: dict, max_abs: dict,
                 totals: dict) -> None:
    """Phases 6-8: K4 against its plain version, the exact-trace path, and
    K4's times.  Fills K4's entries of ``launches``, ``max_abs`` and
    ``totals``."""
    from repro_torch.api import evaluate_scenarios, load_scenarios
    from repro_torch.core import trace as trace_mod
    from repro_torch.core.compose import FullGraphParams
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    k4 = "segment_reduce.schedule_counts"
    # Set-up: the two large graphs (generation, CSR row pointer, and the
    # host factorization every capacity shares).
    t0 = time.perf_counter()
    big = trace_mod.resolve_trace_dataset("power_law_stream", BIG_TRACE)
    mid = trace_mod.resolve_trace_dataset("power_law_stream", MID_TRACE)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big._pair_factorization()
    fact_s = time.perf_counter() - t0
    mid._pair_factorization()
    U = big._pair_factorization()[0].size
    caps = pow2_caps(big.n_nodes, SWEEP_POINTS)
    print(f"# trace set-up: power_law_stream V={big.n_nodes} "
          f"E={big.n_edges} U={U} generated in {gen_s:.3f} s (with the "
          f"10^6-edge graph), factorized on the host in {fact_s:.3f} s; "
          f"capacities {caps}")

    # 6. K4 vs its plain version on the card, bit for bit.  A case is
    # (label, tensors, n_tiles, K, total): total bounds the multiplicities'
    # sum, as a trace passes its edge count, or is None (unknown).
    cases = []
    for name, params in TRACE_DATASETS.items():
        tr = trace_mod.resolve_trace_dataset(name, params)
        t = pair_tensors(tr, dev)
        cases += [(f"{name}@{cap}", t, *tr._geometry(cap), total)
                  for cap in battery_caps(tr.n_nodes)
                  for total in (tr.n_edges, None)]
    V = 3_000_000_000  # ids past int32: the int64-index instantiation
    wide = tuple(torch.tensor(a, device=dev) for a in (
        [0, 5, 2_999_999_999, 2_999_999_999],
        [2_999_999_998, 7, 1, 2_000_000_000],
        [True, True, True, False], [3, 1, 2**40, 1]))
    cases += [(f"int64-ids@{cap}", wide, -(-V // cap),
               -(-V // -(-V // cap)), 2**40 + 5)
              for cap in (V // 2, V // 1000, 12345)]
    for total in (2**53 - 1, 2**53 + 4097):
        hv, arrays = hot_pair_case(total)
        hot = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        cases += [(f"2^53-mult({total})@{cap}", hot, -(-hv // cap),
                   -(-hv // -(-hv // cap)), total) for cap in battery_caps(hv)]
    rv, arrays = route_pairs()
    for n_tiles, total in K4_ROUTE_CASES:
        mult = arrays[3].copy()
        if total is not None:
            mult[mult.size // 2] += total - int(mult.sum())
        tensors = tuple(torch.from_numpy(a).to(dev)
                        for a in (*arrays[:3], mult))
        cases.append((f"route-boundary n_tiles={n_tiles} total={total}",
                      tensors, n_tiles, -(-rv // n_tiles), total))
    big_t = pair_tensors(big, dev)
    cases += [(f"power_law_stream-1e7@{cap}", big_t, *big._geometry(cap),
               big.n_edges) for cap in caps]
    routes = {}
    for label, tensors, n_tiles, K, total in cases:
        route = sr.k4_route(tensors[0].shape[0], n_tiles, total)
        routes[route.describe()] = routes.get(route.describe(), 0) + 1
        got = sr.schedule_counts(*tensors, K, n_tiles, total)
        expect = sr.schedule_counts_plain(*tensors, K, n_tiles)
        err = max(int((g - e).abs().max()) for g, e in zip(got, expect))
        if not all(torch.equal(g, e) for g, e in zip(got, expect)):
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{label} ({route.describe()}): max abs "
                                 f"err {err}")
        if label.startswith(("2^53", "route")):
            print(f"# check {k4} {label}: {route.describe()}, bit-identical")
        max_abs[k4] = max(max_abs[k4], float(err))
    torch.cuda.synchronize()
    print(f"# check {k4}: {len(cases)} cases bit-identical to the plain "
          f"version (tolerance 0), max abs err {max_abs[k4]}; cases by route: "
          f"{json.dumps(routes, sort_keys=True)}")
    if len({(k.split(",")[0], "unpacked" in k) for k in routes}) < 4:
        raise AssertionError(f"K4's routes not all exercised: {routes}")

    # 7. The exact-trace path through the entry points a user calls.
    full = FullGraphParams(V=float(big.n_nodes), E=float(big.n_edges),
                           N=30.0, T=5.0)
    mid_caps = pow2_caps(mid.n_nodes, SWEEP_POINTS)
    ops.reset_launches()
    t0 = time.perf_counter()
    smoke = evaluate_scenarios(load_scenarios(str(TRACE_SMOKE)), device=dev)
    outs = {k: m.evaluate(full)
            for k, m in trace_models(big, caps, dev).items()}
    mid_scheds = mid.schedules(mid_caps, device=dev)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches[k4] = ops.LAUNCHES[k4]
    print(f"# trace path launches: {json.dumps({k4: launches[k4]})} in "
          f"{path_s:.3f} s (host clock)")
    if launches[k4] < 1:
        raise AssertionError(f"{k4} never launched on the trace path")

    got_pins = tuple(r.total_bits for r in smoke.results)
    if smoke.expect_failures() or got_pins != TRACE_SMOKE_PINS:
        raise AssertionError(f"trace_smoke pins: {got_pins} "
                             f"{smoke.expect_failures()}")
    print(f"# trace_smoke: total_bits {got_pins} == pins")
    for name, out in outs.items():
        total = np.asarray(out.total_bits())
        if total.shape != (len(caps),) or not np.all(np.isfinite(total)):
            raise AssertionError(f"{name}: totals {total}")
    # The NumPy engine on a fresh trace of the same edges: its schedules
    # fill that trace's (engine-blind) LRU, so the models read them and
    # launch nothing.
    fresh = trace_mod.GraphTrace(big.senders, big.receivers, big.n_nodes)
    same_schedules(big.schedules(caps), fresh.schedules(caps,
                                                        engine="numpy"),
                   "torch vs numpy engine at 10^7 edges")
    before = ops.LAUNCHES[k4]
    for name, model in trace_models(fresh, caps, "cpu").items():
        expect, got = model.evaluate(full), outs[name]
        if got.names() != expect.names():
            raise AssertionError(f"{name}: terms {got.names()}")
        for t in got.terms:
            e = expect[t.name]
            if not (np.array_equal(t.data_bits, e.data_bits)
                    and np.array_equal(t.iterations, e.iterations)):
                raise AssertionError(f"{name}: term {t.name} differs from "
                                     "the NumPy engine's")
    if ops.LAUNCHES[k4] != before:
        raise AssertionError("the NumPy-engine comparison launched K4")
    same_schedules(mid_scheds, [mid.schedule_reference(c) for c in mid_caps],
                   "torch engine vs schedule_reference at 10^6 edges")
    print(f"# trace sweep: {len(caps)} capacities x {len(outs)} models, "
          "every schedule field and term bit-identical to the NumPy "
          f"engine; 10^6-edge schedules ({len(mid_caps)} capacities) "
          "bit-identical to schedule_reference")
    for name, out in outs.items():
        print(f"#   {name}: total_bits at cap {caps[0]} "
              f"{float(out.total_bits()[0])!r}, at cap {caps[-1]} "
              f"{float(out.total_bits()[-1])!r}")

    # 8. K4's times per capacity, and the host-clock sweep by engine.
    tot = totals[k4]
    s_idx = big_t[1].element_size()
    for cap in caps:
        n_tiles, K = big._geometry(cap)
        tile = (big_t[1] // K).long()
        remote = (big_t[0] // K).long() != tile
        flags = sr.boundary_flags(big_t[2], tile) & remote
        vals = torch.stack([flags.long(), torch.where(
            remote, big_t[3], torch.zeros_like(big_t[3]))], 1).contiguous()
        nbytes = U * (2 * s_idx + 1 + 8) + 16 * n_tiles
        bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        ops_ms = 1e3 * K4_OPS_PER_PAIR * U / PEAK_F32_OPS_PER_S
        route = sr.k4_route(U, n_tiles, big.n_edges)
        row = {
            "ms": time_ms(torch, lambda: sr.schedule_counts(
                *big_t, K, n_tiles, big.n_edges)),
            "plain_ms": time_ms(torch, lambda: sr.schedule_counts_plain(
                *big_t, K, n_tiles)),
            "library_ms": time_ms(torch, lambda: torch.zeros(
                (n_tiles, 2), dtype=torch.int64, device=dev).index_add_(
                    0, tile, vals)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}
        for k, v in row.items():
            tot[k] += v
        print(f"# time {k4} cap={cap} (n_tiles={n_tiles}, K={K}, U={U}, "
              f"int{8 * s_idx} ids; {route.describe()}): kernel "
              f"{row['ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}% "
              f"of the bound), plain {row['plain_ms']:.4f} ms, library "
              f"(index_add_) {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({nbytes} B) | {card}")
    print(f"# time {k4}, the 16 capacities: kernel {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%"
          f"), plain {tot['plain_ms']:.4f} ms, library (index_add_) "
          f"{tot['library_ms']:.4f} ms | {card}")
    t0 = time.perf_counter()
    fresh._device_factorization(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    sweep = {"numpy": [], "torch": []}
    for _ in range(3):
        for engine in sweep:
            fresh.clear_schedules()
            t0 = time.perf_counter()
            fresh.schedules(caps, engine=engine, device=dev)
            sweep[engine].append(time.perf_counter() - t0)
    print(f"# time trace sweep of {len(caps)} capacities (host clock, "
          f"median of 3): numpy engine "
          f"{statistics.median(sweep['numpy']):.4f} s, torch engine "
          f"{statistics.median(sweep['torch']):.4f} s (factorization already on "
          f"the card; its upload took {upload_s:.4f} s); host factorization "
          f"{fact_s:.4f} s; trace path {path_s:.3f} s | {card}")


def percentile(samples, q: float) -> float:
    """The q-th percentile (nearest rank) of a list of samples."""
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, max(0, round(q / 100 * len(ordered))
                                             - 1))]


def device_time_by_kind(fn, kernel: str, fragment: str) -> dict:
    """Device time in ms of the work ``fn`` runs, by kind, from
    ``torch.profiler``: the port's ``kernel`` (names holding ``fragment``),
    cuBLAS matrix products, copies and fills, every other kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {kernel: 0.0, "cuBLAS products": 0.0, "copies": 0.0,
             "other kernels": 0.0}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = event.name.lower()
        kind = (kernel if fragment in name else "cuBLAS products"
                if any(w in name for w in ("nvjet", "gemm", "xmma", "cutlass"))
                else "copies" if "memcpy" in name or "memset" in name
                else "other kernels")
        kinds[kind] += event.device_time / 1e3
    return kinds


def serving_phases(dev, card: str, launches: dict, max_abs: dict,
                   totals: dict) -> None:
    """Phases 9-11: K5 against its plain version, the SmolLM-135M serving
    path, and K5's times.  Fills K5's entries of ``launches``, ``max_abs``
    and ``totals``."""
    import torch.nn.functional as F

    from repro_torch import backend, params
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    k5 = "flash_attention"
    backend.full_fp32()
    # 9. K5 vs its plain version on the card, through the counted wrapper
    # (the counts are zeroed before phase 10).  bf16 cases are also held
    # element by element: kernel and plain version round fp32 results that
    # agree to the f32 tolerance once to bf16, so each element lies within
    # one bf16 step (2^-7 relative) of the plain one, plus the f32 tolerance
    # of the largest output.
    gen = torch.Generator().manual_seed(0)
    main_shape = (SERVE_BATCH, SERVE_PROMPT, 9, 3, 64, 128, True, None,
                  None)
    cases = [(c, key) for c in ATTN_CASES + (main_shape,)
             for key in ATTN_TOLERANCE]
    for (b, s, h, hk, d, block, causal, window, cap), key in cases:
        dtype = torch.float32 if key == "f32" else torch.bfloat16
        q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, dtype)
                   for n in (h, hk, hk))
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cap, block_q=block, block_k=block)
        expect = fa.flash_attention_plain(q, k, v, causal=causal,
                                          window=window, softcap=cap)
        torch.cuda.synchronize()
        err = rel_err(got, expect)
        label = (f"b={b} s={s} h={h} hk={hk} d={d} block={block} "
                 f"causal={causal} window={window} softcap={cap} {key}")
        outside = beyond_bf16_step(got, expect) if key == "bf16" else 0
        print(f"# check {k5} {label}: max rel err {err:.3e} (tolerance "
              f"{ATTN_TOLERANCE[key]:.0e}), max abs err "
              f"{abs_err(got, expect):.3e}, rms of plain output "
              f"{float(expect.float().pow(2).mean().sqrt()):.3e}"
              + (f", {outside} elements beyond one bf16 step"
                 if key == "bf16" else ""))
        if not err < ATTN_TOLERANCE[key] or outside:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{label}: {err}, {outside} elements "
                                 "beyond one bf16 step")
        if (b, s, h, hk, d) == main_shape[:5] and key == "bf16":
            max_abs[k5] = abs_err(got, expect)
        del q, k, v, got, expect

    # 10. The serving path at full width and depth, bf16.
    cfg = smollm_135m.make_config()
    t0 = time.perf_counter()
    weights = params.transformer_params(cfg, seed=0)
    model = params.load_transformer(weights, cfg, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    prefill = tr.make_prefill_step(cfg, max_seq=SERVE_MAX_SEQ)
    serve = tr.make_serve_step(cfg, SERVE_MAX_SEQ)
    print(f"# serving set-up: {cfg.name} {cfg.n_layers} layers d "
          f"{cfg.d_model}, {cfg.param_count()} parameters, {cfg.dtype}; "
          f"seeded weights made and loaded in {load_s:.3f} s; one warm-up "
          "prefill")
    prefill(model, prompts)  # cuBLAS handles and plans; not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits, cache = prefill(model, prompts)
    end.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_ms = start.elapsed_time(end)
    per_prefill = ops.LAUNCHES[k5]
    token = logits.argmax(-1, keepdim=True)
    generated, step_s = [token], []
    for step in range(SERVE_STEPS):
        t0 = time.perf_counter()
        step_logits, cache = serve(model, cache, token,
                                   SERVE_PROMPT + step)
        token = step_logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        generated.append(token)
    launches[k5] = ops.LAUNCHES[k5]
    peak = torch.cuda.max_memory_allocated()
    print(f"# serving path launches: {json.dumps({k5: launches[k5]})} "
          f"({per_prefill} in the prefill)")
    if per_prefill != cfg.n_layers or launches[k5] != cfg.n_layers:
        raise AssertionError(f"K5 launched {per_prefill} times in the "
                             f"prefill and {launches[k5]} in all; expected "
                             f"{cfg.n_layers}, one per layer")
    out = torch.cat(generated, dim=1)
    for name, t in (("prefill logits", logits),
                    ("last decode logits", step_logits)):
        if t.shape != (SERVE_BATCH, cfg.vocab) or not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or not "
                                 "finite")
    if out.shape != (SERVE_BATCH, SERVE_STEPS + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"generated tokens {tuple(out.shape)}")
    n_prompt = SERVE_BATCH * SERVE_PROMPT
    print(f"# serving: prefill of {SERVE_BATCH} x {SERVE_PROMPT} tokens "
          f"{prefill_s * 1e3:.3f} ms host clock, {prefill_ms:.3f} ms CUDA "
          f"events, {n_prompt / prefill_s:.0f} prefill tokens/s; "
          f"{SERVE_STEPS} decode steps: p50 "
          f"{percentile(step_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(step_s, 99) * 1e3:.3f} ms per step ({SERVE_BATCH} "
          "tokens), "
          f"{out.numel()} tokens generated "
          f"({SERVE_BATCH} x {SERVE_STEPS + 1}); peak device memory "
          f"{peak / 2**20:.1f} MiB | {card}")
    # Where the device time goes: one more prefill and 8 decode steps under
    # torch.profiler, outside the counted run.
    pre_kinds = device_time_by_kind(lambda: prefill(model, prompts), "K5",
                                    "flash_wgmma_kernel")
    _, cache = prefill(model, prompts)
    token = generated[0]

    def decode_steps():
        nonlocal cache, token
        for step in range(PROFILED_STEPS):
            lg, cache = serve(model, cache, token, SERVE_PROMPT + step)
            token = lg.argmax(-1, keepdim=True)

    dec_kinds = device_time_by_kind(decode_steps, "K5", "flash_wgmma_kernel")
    step_ms = 1e3 * percentile(step_s, 50)
    for label, kinds, host_ms, n in (
            ("prefill", pre_kinds, prefill_ms, 1),
            ("decode step", dec_kinds, step_ms, PROFILED_STEPS)):
        busy = sum(kinds.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds.items())
        print(f"# where the time goes, {label} (torch.profiler device time"
              f"{'' if n == 1 else f', mean of {n} steps'}): {parts}; "
              f"device busy {busy:.3f} ms of {host_ms:.3f} ms "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    del model, cache, logits, step_logits

    # The f32 checks: card vs CPU, prefill vs decode.
    cfg32 = smollm_135m.make_config(dtype="float32")
    model32 = params.load_transformer(weights, cfg32, device=dev)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, (CHECK_BATCH, CHECK_PROMPT + CHECK_MORE)))
    max_seq = CHECK_PROMPT + CHECK_MORE
    prefill32 = tr.make_prefill_step(cfg32, max_seq=max_seq)
    serve32 = tr.make_serve_step(cfg32, max_seq)
    gpu_tokens = tokens.to(dev)
    lg_p, cache_p = prefill32(model32, gpu_tokens[:, :CHECK_PROMPT])
    cache_d = tr.init_cache(cfg32, CHECK_BATCH, max_seq, device=dev)
    for i in range(CHECK_PROMPT):
        lg_d, cache_d = serve32(model32, cache_d, gpu_tokens[:, i:i + 1], i)
    errs = {"prefill vs decode": rel_err(lg_p, lg_d)}
    lg_card = lg_p.cpu()
    for i in range(CHECK_PROMPT, max_seq):
        lg_p, cache_p = serve32(model32, cache_p, gpu_tokens[:, i:i + 1], i)
        lg_d, cache_d = serve32(model32, cache_d, gpu_tokens[:, i:i + 1], i)
        errs[f"continued decode at pos {i}"] = rel_err(lg_p, lg_d)
    del cache_p, cache_d
    model32.cpu()
    lg_cpu, _ = prefill32(model32, tokens[:, :CHECK_PROMPT])
    errs["card (K5) vs CPU (plain) prefill"] = rel_err(lg_card, lg_cpu)
    for name, err in errs.items():
        print(f"# serving f32 B={CHECK_BATCH} S={CHECK_PROMPT}: {name} max "
              f"rel err {err:.3e} (tolerance {SERVE_TOLERANCE:.0e})")
        if not err < SERVE_TOLERANCE:
            raise AssertionError(f"serving f32 {name}: {err}")
    del model32

    # 11. K5's time at the serving shape, beside the f32 CUDA-core kernel on
    # the same inputs widened to f32, and at gemma2-2b's attention shape.
    b, s, h, hk, d = main_shape[:5]
    q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, torch.bfloat16)
               for n in (h, hk, hk))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    nbytes, nops = k5_work(b, s, h, hk, d)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * nops / PEAK_BF16_OPS_PER_S
    row = {"ms": time_ms(torch, lambda: fa.flash_attention(q, k, v)),
           "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
               q, k, v)),
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               is_causal=True, enable_gqa=True)),
           "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
           "ops_ms": ops_ms}
    f32_ms = time_ms(torch, lambda: fa.flash_attention(q32, k32, v32))
    totals[k5] = row
    print(f"# time {k5} B={b} S={s} H={h} Hk={hk} D={d} bf16: kernel "
          f"{row['ms']:.4f} ms ({nops / row['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound), plain "
          f"{row['plain_ms']:.4f} ms, library (scaled_dot_product_attention) "
          f"{row['library_ms']:.4f} ms (kernel / library "
          f"{row['ms'] / row['library_ms']:.2f}x), bound {row['bound_ms']:.4f}"
          f" ms ({nops} op at the bf16 tensor-core rate; {nbytes} B take "
          f"{bytes_ms:.4f} ms); the f32 CUDA-core kernel on the same inputs "
          f"in f32 {f32_ms:.4f} ms ({f32_ms / row['ms']:.1f}x the kernel; "
          f"{1e3 * nops / PEAK_F32_OPS_PER_S:.4f} ms at the fp32 rate); "
          f"{cfg.n_layers} layers of K5 are "
          f"{100 * cfg.n_layers * row['ms'] / prefill_ms:.1f}% of one prefill"
          f" ({prefill_ms:.3f} ms) | {card}")
    del q, k, v, q32, k32, v32
    b, s, h, hk, d, cap = GEMMA2_ATTENTION
    q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev, torch.bfloat16)
               for n in (h, hk, hk))
    nbytes, nops = k5_work(b, s, h, hk, d)
    bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, softcap=cap))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, softcap=cap))
    print(f"# time {k5} gemma2-2b attention B={b} S={s} H={h} Hk={hk} D={d} "
          f"softcap {cap} causal bf16: kernel {ms:.4f} ms "
          f"({nops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the "
          f"bound), plain {plain_ms:.4f} ms, no library time "
          f"(scaled_dot_product_attention takes no softcap), bound "
          f"{bound:.4f} ms ({nops} op at the bf16 tensor-core rate; {nbytes}"
          f" B) | {card}")


def bag_checks(dev, max_abs: dict) -> None:
    """Phase 12: K6 against its plain version on the card, bit for bit,
    through the counted wrapper (the counts are zeroed before phase 13).
    Fills K6's entry of ``max_abs``."""
    from repro_torch.configs import base
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops, ref

    k6 = "embedding_bag"
    gen = torch.Generator(dev).manual_seed(0)

    def ids(v, *shape):
        return torch.randint(0, v, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def table(v, d):
        return torch.randn(v, d, generator=gen, device=dev)

    # (label, f32 table, ids, out slots of a (B, 27, D) buffer or None)
    cases = [(f"v={v} d={d} b={b} hot={hot}", table(v, d), ids(v, b, hot),
              None) for v, d, b, hot in BAG_CASES]
    # A 20M-row table: rows past 2^24, and the last, so id * D passes 2^31.
    big = ids(DLRM_ROW_CAP, 4096, 2)
    big[0] = torch.tensor([2**24, DLRM_ROW_CAP - 1])
    big[1] = torch.tensor([DLRM_ROW_CAP - 2, 2**24 + 1])
    cases.append((f"v={DLRM_ROW_CAP} d=128 b=4096 hot=2 "
                  f"({int((big >= 2**24).sum())} ids >= 2^24)",
                  table(DLRM_ROW_CAP, 128), big, None))
    # Strided ids (a table's slice of the sparse features) into strided
    # output slots (its slot of the interaction features).
    sparse = ids(1000, 64, 26, 3)
    for t in (0, 13, 25):
        cases.append((f"strided t={t} v=1000 d=128 b=64 hot=3",
                      table(1000, 128), sparse[:, t, :], 1 + t))
    for name in ("serve_p99", "serve_bulk"):
        b = base.RECSYS_SHAPES[name].params["batch"]
        cases.append((f"{name} v=1000000 d=128 b={b} hot=1",
                      table(1_000_000, 128), ids(1_000_000, b, 1), None))
    n = 0
    for label, tab32, idx, slot in cases:
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tab = tab32 if key == "f32" else tab32.to(dtype)
            out = None
            if slot is not None:
                out = torch.zeros(idx.shape[0], 27, tab.shape[1], dtype=dtype,
                                  device=dev)[:, slot]
            got = ops.embedding_bag(tab, idx, out=out)
            expect = eb.embedding_bag_plain(tab, idx)
            torch.cuda.synchronize()
            err = abs_err(got, expect)
            ref_err = (rel_err(got, ref.embedding_bag_ref(tab, idx))
                       if key == "f32" else 0.0)
            if not torch.equal(got, expect) or not ref_err < BAG_REF_TOLERANCE:
                raise AssertionError(f"K6 at {label} {key}: max abs err {err} "
                                     f"vs the plain version, {ref_err} "
                                     "relative vs take-then-sum")
            max_abs[k6] = max(max_abs[k6], err)
            n += 1
            print(f"# check {k6} {label} {key}: bit-identical to the plain "
                  "version" + (f", max rel err vs take-then-sum {ref_err:.3e} "
                               f"(tolerance {BAG_REF_TOLERANCE:.0e})"
                               if key == "f32" else ""))
            del tab, got, expect, out
    del cases
    torch.cuda.empty_cache()
    print(f"# check {k6}: {n} cases bit-identical to the plain version "
          f"(tolerance 0), max abs err {max_abs[k6]}")


def dlrm_phases(dev, card: str, launches: dict, max_abs: dict,
                totals: dict) -> None:
    """Phases 12-14: K6 against its plain version, the DLRM serving path,
    and K6's times.  Fills K6's entries of ``launches``, ``max_abs`` and
    ``totals``."""
    import torch.nn.functional as F

    from repro_torch import backend, params
    from repro_torch.configs import base, dlrm_mlperf
    from repro_torch.data import synthetic
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.models.common import mlp_apply

    k6 = "embedding_bag"
    backend.full_fp32()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on; DLRM serves in f32")
    bag_checks(dev, max_abs)

    # 13. The DLRM serving path.
    cfg = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, DLRM_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    n_cand = base.RECSYS_SHAPES["retrieval_cand"].params["n_candidates"]
    p99_b, bulk_b = (base.RECSYS_SHAPES[k].params["batch"]
                     for k in ("serve_p99", "serve_bulk"))
    weight_bytes = 4 * cfg.param_count()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    if free < weight_bytes + DLRM_ACTIVATION_BYTES:
        raise MemoryError(f"{cfg.name}: {weight_bytes / 1e9:.2f} GB of "
                          f"weights and {DLRM_ACTIVATION_BYTES / 1e9:.0f} GB "
                          f"of activations, {free / 1e9:.2f} GB free")
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    model = dlrm.DLRM(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def criteo(step: int, batch: int) -> dict:
        return synthetic.criteo_batch(0, step, batch=batch,
                                      n_dense=cfg.n_dense,
                                      vocab_sizes=cfg.vocab_sizes,
                                      multi_hot=cfg.multi_hot)

    t0 = time.perf_counter()
    p99 = [criteo(i, p99_b) for i in range(SERVE_P99_REQUESTS)]
    bulk = [criteo(SERVE_P99_REQUESTS + i, bulk_b)
            for i in range(SERVE_BULK_BATCHES)]
    query = {"dense": torch.from_numpy(
        criteo(SERVE_P99_REQUESTS + SERVE_BULK_BATCHES, 1)["dense"]).to(dev)}
    cand = torch.randn(n_cand, cfg.embed_dim, generator=gen, device=dev)
    data_s = time.perf_counter() - t0
    print(f"# DLRM set-up: {cfg.name}, widths as published, "
          f"{sum(cfg.vocab_sizes)} table rows (40M-row tables cut to "
          f"{DLRM_ROW_CAP}), {cfg.param_count()} parameters, "
          f"{weight_bytes / 1e9:.2f} GB f32 drawn on the card in "
          f"{init_s:.3f} s ({free / 1e9:.2f} of {total / 1e9:.2f} GB free "
          f"before); seeded Criteo batches made on the host in {data_s:.3f} s;"
          " one warm-up request at each batch")
    dlrm.serve(model, p99[0])
    dlrm.serve(model, bulk[0])
    dlrm.score_candidates(model, query, cand)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    p99_s, bulk_s = [], []
    for batch in p99:
        t0 = time.perf_counter()
        p99_out = dlrm.serve(model, batch)
        p99_s.append(time.perf_counter() - t0)
    for batch in bulk:
        t0 = time.perf_counter()
        bulk_out = dlrm.serve(model, batch)
        bulk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    scores = dlrm.score_candidates(model, query, cand)
    torch.cuda.synchronize()
    ret_s = time.perf_counter() - t0
    launches[k6] = ops.LAUNCHES[k6]
    peak = torch.cuda.max_memory_allocated()
    forwards = SERVE_P99_REQUESTS + SERVE_BULK_BATCHES
    print(f"# DLRM serving path launches: {json.dumps({k6: launches[k6]})} "
          f"over {forwards} forwards")
    if launches[k6] != cfg.n_sparse * forwards:
        raise AssertionError(f"K6 launched {launches[k6]} times in "
                             f"{forwards} forwards; expected "
                             f"{cfg.n_sparse} per forward")
    for name, out, n in (("serve_p99 logits", p99_out, p99_b),
                         ("serve_bulk logits", bulk_out, bulk_b)):
        if out.shape != (n,) or not np.all(np.isfinite(out)):
            raise AssertionError(f"{name}: shape {out.shape} or not finite")
    if scores.shape != (n_cand,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"retrieval scores {tuple(scores.shape)}")
    bulk_med = statistics.median(bulk_s)
    print(f"# DLRM serving: {SERVE_P99_REQUESTS} serve_p99 requests (B = "
          f"{p99_b}, host clock, copy in + forward + logits back): p50 "
          f"{percentile(p99_s, 50) * 1e3:.3f} ms, p99 "
          f"{percentile(p99_s, 99) * 1e3:.3f} ms; {SERVE_BULK_BATCHES} "
          f"serve_bulk batches (B = {bulk_b}): median "
          f"{bulk_med * 1e3:.3f} ms, {bulk_b / bulk_med:.0f} samples/s "
          f"({bulk_b * SERVE_BULK_BATCHES / sum(bulk_s):.0f} over all "
          f"{SERVE_BULK_BATCHES}); retrieval_cand ({n_cand} candidates) "
          f"{ret_s * 1e3:.3f} ms; peak device memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB) | {card}")

    # The checks: the plain embedding bag on the card, bit for bit; f32 on
    # the card against the CPU; retrieval against the CPU.
    last = bulk[-1]
    with torch.inference_mode():
        dense = torch.from_numpy(last["dense"]).to(dev)
        sparse = torch.from_numpy(last["sparse"]).to(dev)
        feats = torch.stack([model.bottom(dense)] + [
            eb.embedding_bag_plain(tab, sparse[:, t, :])
            for t, tab in enumerate(model.tables)], dim=1)
        plain = model.top_logits(feats).cpu().numpy()
        del dense, sparse, feats
    if not np.array_equal(bulk_out, plain):
        raise AssertionError("serve_bulk logits differ from the forward with "
                             "the plain embedding bag: max abs err "
                             f"{float(np.abs(bulk_out - plain).max())}")
    print(f"# DLRM check: serve_bulk logits (B = {bulk_b}) bit-identical to "
          "the forward with the plain embedding bag on the card")
    bot_cpu = {k: [t.cpu() for t in v] for k, v in model.mlp("bot").items()}
    with torch.inference_mode():
        user = mlp_apply(bot_cpu, query["dense"].cpu(), final_act=True)
        expect = cand.cpu() @ user[0]
    ret_err = rel_err(scores.cpu(), expect)
    small = dlrm_mlperf.make_config(vocab_sizes=tuple(
        min(v, DLRM_CHECK_ROW_CAP) for v in dlrm.CRITEO_1TB_VOCABS))
    weights = params.dlrm_params(small, seed=1)
    batch = synthetic.criteo_batch(1, 0, batch=DLRM_CHECK_BATCH,
                                   n_dense=small.n_dense,
                                   vocab_sizes=small.vocab_sizes)
    on_card = dlrm.serve(params.load_dlrm(weights, small, device=dev), batch)
    on_cpu = dlrm.serve(params.load_dlrm(weights, small, device="cpu"), batch)
    f32_err = rel_err(torch.from_numpy(on_card), torch.from_numpy(on_cpu))
    for name, err, tol in (
            (f"f32 logits, card (K6) vs CPU (plain), tables capped at "
             f"{DLRM_CHECK_ROW_CAP} rows ({4 * small.param_count() / 1e9:.2f}"
             f" GB), B = {DLRM_CHECK_BATCH}", f32_err, DLRM_TOLERANCE),
            (f"retrieval scores ({n_cand}), card vs CPU", ret_err,
             RETRIEVAL_TOLERANCE)):
        print(f"# DLRM check: {name}: max rel err {err:.3e} (tolerance "
              f"{tol:.0e})")
        if not err < tol:
            raise AssertionError(f"DLRM {name}: {err}")

    # 14. K6 per table at both batches, the sums over one serve_bulk forward
    # into the kernels line; then the profiler split.
    d = cfg.embed_dim
    tot = totals[k6]
    for name, batch in (("serve_p99", p99[0]), ("serve_bulk", last)):
        b = batch["sparse"].shape[0]
        sparse = torch.from_numpy(batch["sparse"]).to(dev)
        feats = torch.empty(b, cfg.n_sparse + 1, d, device=dev)
        row = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bytes_ms", "ops_ms")}
        for t, tab in enumerate(model.tables):
            idx, slot = sparse[:, t, :], feats[:, t + 1]
            flat = idx.contiguous()
            hot = idx.shape[1]
            uniq = np.unique(batch["sparse"][:, t, :]).size
            nbytes = 4 * (uniq * d + b * d + b * hot)
            cell = {
                "ms": time_ms(torch, lambda: eb.embedding_bag(tab, idx,
                                                              out=slot)),
                "plain_ms": time_ms(torch, lambda: eb.embedding_bag_plain(
                    tab, idx)),
                "library_ms": time_ms(torch, lambda: F.embedding_bag(
                    flat, tab, mode="sum")),
                "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                "ops_ms": 1e3 * b * d * (hot - 1) / PEAK_F32_OPS_PER_S}
            cell["bound_ms"] = max(cell["bytes_ms"], cell["ops_ms"])
            for k, v in cell.items():
                row[k] += v
            print(f"# time {k6} {name} table {t} (V={tab.shape[0]}, "
                  f"{uniq} distinct of {b * hot} ids): kernel "
                  f"{cell['ms']:.4f} ms, plain {cell['plain_ms']:.4f} ms, "
                  f"library (F.embedding_bag) {cell['library_ms']:.4f} ms, "
                  f"bound {cell['bound_ms']:.4f} ms ({nbytes} B)")
        print(f"# time {k6} {name} (B = {b}, f32), sum over the "
              f"{cfg.n_sparse} tables: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms,"
              f" bound {row['bound_ms']:.4f} ms | {card}")
        if name == "serve_bulk":
            tot.update(row)
        del sparse, feats
    bulk_kinds = device_time_by_kind(lambda: dlrm.serve(model, last), "K6",
                                     "embedding_bag_kernel")
    p99_kinds = device_time_by_kind(
        lambda: [dlrm.serve(model, b) for b in p99[:PROFILED_REQUESTS]], "K6",
        "embedding_bag_kernel")
    for label, kinds, host_ms, n in (
            (f"serve_bulk request (B = {bulk_b})", bulk_kinds,
             1e3 * bulk_med, 1),
            (f"serve_p99 request (B = {p99_b})", p99_kinds,
             1e3 * percentile(p99_s, 50), PROFILED_REQUESTS)):
        busy = sum(kinds.values()) / n
        parts = ", ".join(f"{k} {v / n:.3f} ms" for k, v in kinds.items())
        print(f"# where the time goes, {label} (torch.profiler device time"
              f"{'' if n == 1 else f', mean of {n} requests'}): {parts}; "
              f"device busy {busy:.3f} ms of {host_ms:.3f} ms host clock "
              f"({100 * busy / host_ms:.1f}%, the rest idle) | {card}")
    del model, cand, scores
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import backend, data, params
    from repro_torch.core import conformance
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import edge_aggregate as ea
    from repro_torch.kernels import edge_aggregate_unfused as eu

    dev = backend.resolve_device("cuda")
    t_start = time.perf_counter()

    # 1. device
    card = backend.card_report()
    print(f"# device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"# build: {time.perf_counter() - t0:.3f} s into {out_dir}")
    entries, spills, regs = 0, [], []
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            entries += 1
            entry = line.split("'")[1]
        elif "spill stores" in line and not line.strip().startswith("0 bytes"):
            spills.append(f"{entry}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
    print(f"# ptxas: {entries} kernels, registers {min(regs)}-{max(regs)}, "
          f"{len(spills)} with spills")
    for line in spills:
        print(f"#   spill {line}")
    log = build.build_log()
    rows = (k5_ptxas(log) + aggregate_ptxas(log) + combine_ptxas(log)
            + k4_ptxas(log))
    for line in rows:
        print(f"# ptxas {line}")
    spilling = [line for line in rows if " 0 bytes spill stores" not in line]
    if spilling:
        raise AssertionError(f"kernel instances spill: {spilling}")

    # Inputs of the main path: the seeded Cora-sized graph, padded.
    (cora1, cora2) = conformance.cora_operating_points()
    graph = data.cora_graph(seed=0)
    a = torch.as_tensor(graph.dense_adjacency(cora1.K), device=dev)
    x = torch.as_tensor(data.cora_features(seed=0, n_pad=cora1.K), device=dev)
    w1, w2 = params.gcn_combine_weights(params.gcn_params(data.CORA_WIDTHS,
                                                          seed=0), device=dev)
    h1 = torch.relu(ea.fused_aggregate_combine_plain(a, x, w1))
    cora_inputs = {"cora_layer1": (cora1, a, x, w1),
                   "cora_layer2": (cora2, a, h1, w2)}

    # 3. kernels vs plain versions
    gen = torch.Generator().manual_seed(0)
    cases = []
    for n, f, t, bn, bk in TEST_SHAPES:
        ta = (torch.rand(n, n, generator=gen) < 0.02) * torch.rand(
            n, n, generator=gen)
        cases.append((f"shape{n}x{f}x{t}", bn, bk,
                      ta.to(dev), torch.randn(n, f, generator=gen).to(dev),
                      torch.randn(f, t, generator=gen).to(dev)))
    for n, f, t, bn, bk in CLUSTER_SHAPES:
        ta = (torch.rand(n, n, generator=gen) < 0.02) * torch.rand(
            n, n, generator=gen)
        cases.append((f"cluster{n}x{f}x{t}", bn, bk,
                      ta.to(dev), torch.randn(n, f, generator=gen).to(dev),
                      torch.randn(f, t, generator=gen).to(dev)))
    for name, (pt, ca, cx, cw) in cora_inputs.items():
        cases.append((name, pt.Bn, pt.Bk, ca, cx, cw))
    max_abs = {k: 0.0 for k in KERNELS}
    for label, bn, bk, ca, cx, cw in cases:
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            va, vx, vw = (v.to(dtype).contiguous() for v in (ca, cx, cw))
            y_plain = eu.aggregate_pass_plain(va, vx)
            checks = {
                "edge_aggregate": (
                    ea.fused_aggregate_combine(va, vx, vw, block_n=bn,
                                               block_k=bk),
                    ea.fused_aggregate_combine_plain(va, vx, vw)),
                "edge_aggregate_unfused.aggregate": (
                    eu.aggregate_pass(va, vx, block_n=bn, block_k=bk),
                    y_plain),
                "edge_aggregate_unfused.combine": (
                    eu.combine_pass(y_plain, vw, block_n=bn),
                    eu.combine_pass_plain(y_plain, vw)),
            }
            torch.cuda.synchronize()
            for kname, (got, expect) in checks.items():
                err = rel_err(got, expect)
                print(f"# check {kname} {label} {key}: max rel err {err:.3e} "
                      f"(tolerance {TOLERANCE[key]:.0e}), max abs err "
                      f"{abs_err(got, expect):.3e}")
                if not err < TOLERANCE[key]:
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version at {label} {key}: {err}")
                if key == "f32" and label.startswith("cora"):
                    max_abs[kname] = max(max_abs[kname], abs_err(got, expect))

    # 4. main path: GCN-Cora forward, fused and unfused, and conformance.
    ops.reset_launches()
    fused = ops.gnn_aggregate_combine(
        a, torch.relu(ops.gnn_aggregate_combine(a, x, w1, block_n=cora1.Bn,
                                                block_k=cora1.Bk)),
        w2, block_n=cora2.Bn, block_k=cora2.Bk)
    agg1 = ops.gnn_aggregate(a, x, block_n=cora1.Bn, block_k=cora1.Bk)
    h1u = torch.relu(ops.gnn_combine(agg1, w1, block_n=cora1.Bn))
    unfused = ops.gnn_combine(
        ops.gnn_aggregate(a, h1u, block_n=cora2.Bn, block_k=cora2.Bk),
        w2, block_n=cora2.Bn)
    records = conformance.run_conformance(device=dev)
    numerics, worst = max(((conformance.verify_numerics(pt, device=dev), pt)
                           for pt in conformance.operating_points()),
                          key=lambda e: e[0])
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in LAYER_KERNELS}
    print(f"# GNN layer path launches: {json.dumps(launches, sort_keys=True)}")
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"{kname} never launched on the GNN layer "
                                 "path")

    expect = ea.fused_aggregate_combine_plain(a, h1, w2)
    for label, got in (("fused", fused), ("unfused", unfused)):
        if got.shape != (cora1.K, data.CORA_WIDTHS[-1]):
            raise AssertionError(f"{label} logits have shape {got.shape}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} logits are not finite")
        if bool(got[data.CORA_V:].any()):
            raise AssertionError(f"{label} padding rows are not zero")
        err = rel_err(got, expect)
        print(f"# GCN-Cora forward {label}: logits {tuple(got.shape)}, max "
              f"rel err vs plain {err:.3e} (tolerance {TOLERANCE['f32']:.0e})")
        if not err < TOLERANCE["f32"]:
            raise AssertionError(f"{label} forward disagrees: {err}")
    summary = conformance.summarize_records(records)
    print(f"# conformance: {summary['n_ok']}/{summary['n_records']} records "
          f"within tolerance over {len(conformance.operating_points())} "
          f"points; numerics max rel err {numerics:.3e} at K={worst.K} "
          f"N={worst.N} T={worst.T} Bn={worst.Bn} Bk={worst.Bk} (tolerance "
          f"{conformance.NUMERICS_REL_TOL:.0e})")
    if not summary["all_ok"]:
        raise AssertionError("conformance failures: " + "; ".join(
            str(r) for r in records if not r.ok))
    if not numerics < conformance.NUMERICS_REL_TOL:
        raise AssertionError(f"conformance numerics {numerics}")

    # 5. times at each Cora layer, f32 (and bf16 K1, K2 at layer 1).
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
              for k in KERNELS}
    layer_ms = {"fused": 0.0, "unfused": 0.0, "spill_ms": 0.0}
    for label, (pt, ca, cx, cw) in cora_inputs.items():
        K, F, T = pt.K, pt.N, pt.T
        y = eu.aggregate_pass_plain(ca, cx)
        nnz = int(torch.count_nonzero(ca))
        # Each input read once and each output written once; operations are
        # what this data needs: the nonzeros of A, the dense combine.
        work = {
            "edge_aggregate": (4 * (K * K + K * F + F * T + K * T),
                               2 * nnz * F + 2 * K * F * T),
            "edge_aggregate_unfused.aggregate": (4 * (K * K + 2 * K * F),
                                                 2 * nnz * F),
            "edge_aggregate_unfused.combine": (4 * (K * F + F * T + K * T),
                                               2 * K * F * T),
        }
        runs = {
            "edge_aggregate": (
                lambda: ea.fused_aggregate_combine(ca, cx, cw, block_n=pt.Bn,
                                                   block_k=pt.Bk),
                lambda: ea.fused_aggregate_combine_plain(ca, cx, cw),
                lambda: torch.linalg.multi_dot([ca, cx, cw])),
            "edge_aggregate_unfused.aggregate": (
                lambda: eu.aggregate_pass(ca, cx, block_n=pt.Bn,
                                          block_k=pt.Bk),
                lambda: eu.aggregate_pass_plain(ca, cx),
                lambda: torch.matmul(ca, cx)),
            "edge_aggregate_unfused.combine": (
                lambda: eu.combine_pass(y, cw, block_n=pt.Bn),
                lambda: eu.combine_pass_plain(y, cw),
                lambda: torch.matmul(y, cw)),
        }
        for kname, (kernel, plain, library) in runs.items():
            nbytes, nops = work[kname]
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ops_ms = 1e3 * nops / PEAK_F32_OPS_PER_S
            row = {"ms": time_ms(torch, kernel),
                   "plain_ms": time_ms(torch, plain),
                   "library_ms": time_ms(torch, library),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            for k, v in row.items():
                totals[kname][k] += v
            extra = ""
            if kname != "edge_aggregate_unfused.combine":
                extra = ", block-dense bound " + dense_bound(
                    conformance, ea, eu, kname, pt, "f32")
            if kname == "edge_aggregate":
                same = time_ms(torch, lambda: torch.matmul(
                    torch.matmul(ca, cx), cw))
                extra += f", library (A @ X) @ W {same:.4f} ms"
            if kname == "edge_aggregate_unfused.combine":
                extra += (f", {100 * row['bound_ms'] / row['ms']:.1f}% of "
                          "its bound")
            extra += ", " + cluster_fit(build, ea, eu, kname, pt)
            print(f"# time {kname} {label} (K={K} N={F} T={T} Bn={pt.Bn} "
                  f"Bk={pt.Bk}, f32, nnz(A)={nnz}): kernel {row['ms']:.4f} ms"
                  f", plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({nbytes} B, {nops} op){extra} | {card}")
            if kname == "edge_aggregate":
                layer_ms["fused"] += row["ms"]
            else:
                layer_ms["unfused"] += row["ms"]
        # The spill the unfused pair adds: writeinterphase + readinterphase.
        layer_ms["spill_ms"] += 1e3 * 2 * K * F * 4 / PEAK_BYTES_PER_S
        if label == "cora_layer1":
            va, vx, vw = (v.to(torch.bfloat16).contiguous()
                          for v in (ca, cx, cw))
            for kname, kernel in (
                    ("edge_aggregate", lambda: ea.fused_aggregate_combine(
                        va, vx, vw, block_n=pt.Bn, block_k=pt.Bk)),
                    ("edge_aggregate_unfused.aggregate",
                     lambda: eu.aggregate_pass(va, vx, block_n=pt.Bn,
                                               block_k=pt.Bk))):
                print(f"# time {kname} {label} bf16: kernel "
                      f"{time_ms(torch, kernel):.4f} ms, block-dense bound "
                      f"{dense_bound(conformance, ea, eu, kname, pt, 'bf16')}"
                      f" | {card}")
    k3 = totals["edge_aggregate_unfused.combine"]
    print(f"# time edge_aggregate_unfused.combine, both Cora layers, f32: "
          f"kernel {k3['ms']:.4f} ms, library (matmul) {k3['library_ms']:.4f}"
          f" ms (kernel / library {k3['ms'] / k3['library_ms']:.2f}x), bound "
          f"{k3['bound_ms']:.4f} ms ({100 * k3['bound_ms'] / k3['ms']:.1f}%) "
          f"| {card}")
    print(f"# fused minus unfused, both Cora layers, f32: K2 + K3 - K1 = "
          f"{layer_ms['unfused'] - layer_ms['fused']:.4f} ms against a "
          f"modelled spill of {layer_ms['spill_ms']:.4f} ms "
          f"(writeinterphase + readinterphase at {PEAK_BYTES_PER_S:.3g} B/s)"
          f" | {card}")

    trace_phases(dev, card, launches, max_abs, totals)
    serving_phases(dev, card, launches, max_abs, totals)
    dlrm_phases(dev, card, launches, max_abs, totals)

    kernels = []
    for kname, meta in KERNELS.items():
        tot = totals[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": max_abs[kname], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"],
        })
    print(f"# wall time {time.perf_counter() - t_start:.1f} s; K1-K3 times "
          "are sums over the two GCN-Cora layers, f32; K4's over the 16 "
          "capacities of the 10^7-edge sweep; K5's one layer of the "
          "SmolLM-135M prefill, bf16; K6's the 26 tables of one serve_bulk "
          "forward of DLRM-MLPerf, f32")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
