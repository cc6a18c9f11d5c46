#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's GNN layer on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; without a card it exits 1 and prints no
result.  Phases, any failure of which ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles the kernels under ``src/repro_torch/csrc``;
3. kernels vs plain versions: K1 (fused), K2 (aggregate) and K3 (combine)
   on the card, f32 and bf16, at the reference's four kernel-test shapes and
   at the two full-width GCN-Cora layers (seeded Cora-sized graph, GCN
   weights in the reference layout), against their plain PyTorch versions;
4. main path: the launch counters are zeroed, then the 2-layer GCN-Cora
   forward runs fused and unfused through ``repro_torch.kernels.ops``, and
   the conformance harness holds the kernels' byte schedules to their
   closed forms at all twelve operating points and runs them against the
   fp32 oracle; the counters are read right after, and every kernel must
   have launched;
5. times at each Cora layer (CUDA events, median, warm L2): each kernel
   beside its bound, its plain version and one PyTorch library call that
   computes the same function (timed here only; the port never calls it).

The last three lines of standard output are the ``kernels`` JSON line, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

#: f32 against the fp32 plain versions (sums in another order); bf16 allows
#: one bf16 rounding of the output (and of the spilled aggregate).
TOLERANCE = {"f32": 1e-5, "bf16": 3e-2}
#: The reference's fused-kernel test shapes (n, f, t, block_n, block_k).
TEST_SHAPES = ((256, 32, 8, 128, 128), (512, 64, 16, 128, 256),
               (512, 128, 32, 256, 256), (1024, 16, 7, 256, 512))
#: Published H100 SXM peaks at 700 W: HBM bytes/s, fp32 (non-tensor) op/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
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
}


def rel_err(out, expect) -> float:
    out, expect = out.float(), expect.float()
    return float((out - expect).abs().max() / (expect.abs().max() + 1e-9))


def abs_err(out, expect) -> float:
    return float((out.float() - expect.float()).abs().max())


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def main() -> int:
    import torch

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
    numerics = max(conformance.verify_numerics(pt, device=dev)
                   for pt in conformance.operating_points())
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"# main path launches: {json.dumps(launches, sort_keys=True)}")
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"{kname} never launched on the main path")

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
          f"points; numerics max rel err {numerics:.3e} (tolerance "
          f"{conformance.NUMERICS_REL_TOL:.0e})")
    if not summary["all_ok"]:
        raise AssertionError("conformance failures: " + "; ".join(
            str(r) for r in records if not r.ok))
    if not numerics < conformance.NUMERICS_REL_TOL:
        raise AssertionError(f"conformance numerics {numerics}")

    # 5. times at each Cora layer, f32.
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
              for k in KERNELS}
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
            print(f"# time {kname} {label} (K={K} N={F} T={T} Bn={pt.Bn} "
                  f"Bk={pt.Bk}, f32, nnz(A)={nnz}): kernel {row['ms']:.4f} ms"
                  f", plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({nbytes} B, {nops} op) | {card}")

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
    print(f"# wall time {time.perf_counter() - t_start:.1f} s; times are sums "
          "over the two GCN-Cora layers, f32")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
