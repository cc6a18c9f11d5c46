"""Measured-vs-modeled conformance of the port's GNN layer kernels.

Holds the byte schedule of the fused kernel K1 and of the unfused pair
K2 + K3 to the ``spmm_tiled_cta`` / ``spmm_unfused_cta`` closed forms, at
every operating point, and checks the paper's fusion claim: unfused bytes
minus fused bytes equal exactly ``writeinterphase + readinterphase``.

Measurement layers (each a ``ConformanceRecord.source``):

``block_schedule``
    A per-CTA trace built from the kernel module's own geometry function
    (``*_grid_spec``, which the launch also reads): every CTA of the grid
    moves the blocks its schedule lists, and nothing carries over between
    CTAs — blocks run in no order on the card.  Bytes are attributed to
    movement levels through the ``*_block_streams`` helpers.
``launch_boundary``
    The ``nbytes`` of every tensor passed to each launch, from the same
    function that validates and allocates them for the kernel.  It must
    equal the block cover of the declared streams, and the unfused pair's
    boundary exceeds the fused kernel's by the spilled aggregate, twice.

Before any measurement, :func:`run_conformance` passes every dataflow it
is asked for, and the kernel spec each is held to, through the static model
auditor (:mod:`repro_torch.analysis`) and refuses a spec with a strict
error.  The reference harness's ``cost_analysis`` layer reads an XLA
artefact and has no counterpart here; its ``hlo_collectives`` record is
``collective_wire`` from the collective ledger
(:class:`repro_torch.distributed.comm.CollectiveLedger`): the wire bytes of
every collective issued while a program is measured, 0 for these
single-device kernels, held to 0.

Run it as ``python -m repro_torch.core.conformance [--device cuda|cpu]
[--points M] [--execute] [--json PATH]``; it exits non-zero on any
violation.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..backend import resolve_device
from .dataflow import DataflowSpec
from .notation import GraphTileParams

__all__ = [
    "OperatingPoint",
    "CHECK_POINT",
    "ConformanceRecord",
    "ProgramMeasurement",
    "FusedCtaAnalogue",
    "UnfusedCtaAnalogue",
    "default_operating_points",
    "cora_operating_points",
    "operating_points",
    "block_schedule",
    "launch_boundary",
    "measure_program",
    "conformance_records",
    "interphase_delta",
    "run_conformance",
    "verify_numerics",
    "summarize_records",
    "EXACT_REL_TOL",
    "NUMERICS_REL_TOL",
    "main",
]

#: Declared tolerance for sources that are exact algebra in float64.
EXACT_REL_TOL = 1e-9
#: ``verify_numerics`` bar: f32 kernels against the fp32 plain oracle.
NUMERICS_REL_TOL = 1e-5

_DTYPE_OF_BYTES = {4.0: torch.float32, 2.0: torch.bfloat16}


@dataclass(frozen=True)
class OperatingPoint:
    """One point of the kernel sweep: tile sizes in the paper's notation
    (K vertices, N in-features, T out-features) plus the kernel block
    shape."""

    K: int
    N: int
    T: int
    Bn: int
    Bk: int
    elem_bytes: float = 4.0   # f32 kernels; sigma = 8 * elem_bytes bits

    def __post_init__(self) -> None:
        if self.K % self.Bn or self.K % self.Bk:
            raise ValueError(f"K={self.K} must divide into Bn={self.Bn} / "
                             f"Bk={self.Bk} blocks (the kernels assert this)")

    @property
    def sigma_bits(self) -> float:
        return 8.0 * self.elem_bytes

    def graph(self) -> GraphTileParams:
        """The tile in Table II notation.  L and P do not enter the
        block-dense closed forms; they carry the paper's defaults."""
        return GraphTileParams(N=self.N, T=self.T, K=self.K,
                               L=self.K // 10, P=10 * self.K)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: The reference's one-point check, as the registry crosscheck and the front
#: door's conformance blocks run it.
CHECK_POINT = OperatingPoint(256, 16, 8, 128, 128)


def default_operating_points() -> tuple[OperatingPoint, ...]:
    """The reference's ten-point sweep over K, N and (Bn, Bk), including
    the single-source-block (nbk == 1) and single-dst-block (nbn == 1)
    schedules."""
    pts = [OperatingPoint(K, N, 8, Bn, Bk)
           for K in (256, 512)
           for N in (16, 32)
           for Bn, Bk in ((128, 128), (128, 256))]
    pts.append(OperatingPoint(256, 16, 8, 256, 256))
    pts.append(OperatingPoint(512, 32, 8, 512, 128))
    return tuple(pts)


def cora_operating_points() -> tuple[OperatingPoint, ...]:
    """The two GCN-Cora layers at full width: V = 2708 padded to 2816
    (22 x 128), widths 1433 -> 16 -> 7.

    The block heights are the fastest of 16 ... 256 in a sweep on an H100:
    layer 1 takes Bn = 32 (88 CTAs, each re-reading its adjacency rows in
    6 feature chunks of 256); layer 2 (N = 16, one chunk) takes Bn = 64.
    """
    return (OperatingPoint(2816, 1433, 16, 32, 256),
            OperatingPoint(2816, 16, 7, 64, 256))


def operating_points() -> tuple[OperatingPoint, ...]:
    """All twelve: the reference's ten plus the two Cora layers."""
    return default_operating_points() + cora_operating_points()


@dataclass(frozen=True)
class ConformanceRecord:
    """One analytical-vs-measured comparison with a declared tolerance."""

    dataflow: str
    movement: str          # movement-level name or an aggregate probe
    source: str            # block_schedule | launch_boundary | collective_ledger
    point: Mapping
    analytical_bytes: float
    measured_bytes: float
    tolerance: float
    one_sided: bool = False   # pass iff measured >= analytical * (1 - tol)

    @property
    def ratio(self) -> float:
        """measured / analytical (1.0 when both sides are zero)."""
        if self.analytical_bytes == 0.0:
            return 1.0 if self.measured_bytes == 0.0 else float("inf")
        return self.measured_bytes / self.analytical_bytes

    @property
    def ok(self) -> bool:
        if self.one_sided:
            return self.measured_bytes >= self.analytical_bytes * (1.0 - self.tolerance)
        if self.analytical_bytes == 0.0:
            return self.measured_bytes == 0.0
        return abs(self.ratio - 1.0) <= self.tolerance

    def as_row(self) -> dict:
        row = {"dataflow": self.dataflow, "movement": self.movement,
               "source": self.source,
               "analytical_bytes": self.analytical_bytes,
               "measured_bytes": self.measured_bytes,
               "ratio": self.ratio, "tolerance": self.tolerance,
               "one_sided": self.one_sided, "ok": self.ok}
        row.update({k: v for k, v in dict(self.point).items()})
        return row

    def __str__(self) -> str:  # pragma: no cover - repr
        flag = "OK " if self.ok else "FAIL"
        return (f"[{flag}] {self.dataflow}.{self.movement} ({self.source}): "
                f"analytical={self.analytical_bytes:.6g}B "
                f"measured={self.measured_bytes:.6g}B ratio={self.ratio:.4f}")


@dataclass(frozen=True)
class ProgramMeasurement:
    """One launch: its CTA schedule, its movement-named streams and the
    tensors it is given."""

    label: str
    schedule: object                  # kernels.edge_aggregate.CtaSchedule
    streams: Mapping[str, Mapping]    # movement name -> stream descriptor
    tensors: tuple[torch.Tensor, ...]


def block_schedule(schedule, streams: Mapping[str, Mapping]) -> dict:
    """Trace every CTA of a launch: per movement, the bytes moved, the
    number of block transfers, and the distinct footprint (each element
    once), which is that operand's share of the launch boundary."""
    by_operand = {s["operand"]: name for name, s in streams.items()}
    traced = {name: {"bytes": 0.0, "transfers": 0} for name in streams}
    cover = {op: np.zeros(shape, bool)
             for op, shape in schedule.operands.items() if op in by_operand}
    for i in range(math.prod(schedule.grid)):
        for op, (r0, r1), (c0, c1) in schedule.moves(i):
            name = by_operand[op]
            traced[name]["bytes"] += ((r1 - r0) * (c1 - c0)
                                      * float(streams[name]["elem_bytes"]))
            traced[name]["transfers"] += 1
            cover[op][r0:r1, c0:c1] = True
    for name, s in streams.items():
        traced[name]["distinct_bytes"] = (float(cover[s["operand"]].sum())
                                          * float(s["elem_bytes"]))
    return traced


def launch_boundary(tensors: Sequence[torch.Tensor]) -> float:
    """Bytes of every tensor a launch is given, inputs and outputs."""
    return float(sum(t.nbytes for t in tensors))


def measure_program(pm: ProgramMeasurement) -> dict:
    """The measurement layers for one launch."""
    from ..distributed import comm

    with comm.recording() as ledger:
        per_stream = block_schedule(pm.schedule, pm.streams)
        boundary = launch_boundary(pm.tensors)
    return {
        "collective_wire_bytes": ledger.total_wire_bytes_per_chip,
        "label": pm.label,
        "streams": per_stream,
        "stream_total_bytes": sum(s["bytes"] for s in per_stream.values()),
        "distinct_total_bytes": sum(s["distinct_bytes"]
                                    for s in per_stream.values()),
        "boundary_bytes": boundary,
    }


class _CtaAnalogueBase:
    """Shared machinery of the fused/unfused kernel analogues: the launch
    tensors are allocated (never filled) on the chosen device by the kernel
    module's own validate-and-allocate function."""

    dataflow: str

    def graph_hw(self, spec: DataflowSpec, point: OperatingPoint):
        """The (graph, hw) pair putting the spec at the kernel's operating
        point: kernel dtype width as sigma, kernel blocks as Bn/Bk."""
        hw = spec.resolve_hw().replace(sigma=point.sigma_bits,
                                       sigma_adj=point.sigma_bits,
                                       Bn=point.Bn, Bk=point.Bk)
        return point.graph(), hw

    @staticmethod
    def _empty(point: OperatingPoint, device, *shape) -> torch.Tensor:
        return torch.empty(shape, dtype=_DTYPE_OF_BYTES[point.elem_bytes],
                           device=device)

    def programs(self, point: OperatingPoint,
                 device) -> tuple[ProgramMeasurement, ...]:
        raise NotImplementedError


class FusedCtaAnalogue(_CtaAnalogueBase):
    """Kernel K1 <-> the ``spmm_tiled_cta`` dataflow."""

    dataflow = "spmm_tiled_cta"

    def programs(self, point, device):
        from ..kernels import edge_aggregate as ea
        K, N, T = point.K, point.N, point.T
        sched, tensors = ea.fused_launch_tensors(
            self._empty(point, device, K, K), self._empty(point, device, K, N),
            self._empty(point, device, N, T),
            block_n=point.Bn, block_k=point.Bk)
        acct = ea.fused_block_streams(K, N, T, block_n=point.Bn,
                                      block_k=point.Bk,
                                      elem_bytes=point.elem_bytes)
        return (ProgramMeasurement("fused", sched, acct["streams"], tensors),)


class UnfusedCtaAnalogue(_CtaAnalogueBase):
    """Kernels K2 + K3 <-> the ``spmm_unfused_cta`` dataflow."""

    dataflow = "spmm_unfused_cta"

    def programs(self, point, device):
        from ..kernels import edge_aggregate_unfused as eu
        K, N, T = point.K, point.N, point.T
        agg_sched, agg_tensors = eu.aggregate_launch_tensors(
            self._empty(point, device, K, K), self._empty(point, device, K, N),
            block_n=point.Bn, block_k=point.Bk)
        agg_acct = eu.aggregate_block_streams(K, N, block_n=point.Bn,
                                              block_k=point.Bk,
                                              elem_bytes=point.elem_bytes)
        comb_sched, comb_tensors = eu.combine_launch_tensors(
            agg_tensors[-1], self._empty(point, device, N, T),
            block_n=point.Bn)
        comb_acct = eu.combine_block_streams(K, N, T, block_n=point.Bn,
                                             elem_bytes=point.elem_bytes)
        return (
            ProgramMeasurement("aggregate", agg_sched, agg_acct["streams"],
                               agg_tensors),
            ProgramMeasurement("combine", comb_sched, comb_acct["streams"],
                               comb_tensors),
        )


def measure_analogue(analogue, point: OperatingPoint, device) -> list[dict]:
    return [measure_program(pm) for pm in analogue.programs(point, device)]


def conformance_records(spec: DataflowSpec, point: OperatingPoint, *,
                        device=None, measures: list[dict] | None = None
                        ) -> list[ConformanceRecord]:
    """All conformance records of one runnable dataflow at one point.

    The records hold the dataflow's kernel analogue to the kernel spec it
    names (``spmm_tiled`` and ``spmm_tiled_cta`` both to ``spmm_tiled_cta``),
    and carry that spec's name."""
    from . import registry

    analogue = spec.runnable_analogue()
    spec = registry.get(analogue.dataflow)
    graph, hw = analogue.graph_hw(spec, point)
    out = spec.evaluate(graph, hw)
    if measures is None:
        measures = measure_analogue(analogue, point, resolve_device(device))
    pt = point.as_dict()
    records: list[ConformanceRecord] = []

    # Per movement level: the traced per-CTA schedule.
    for meas in measures:
        for movement, traced in meas["streams"].items():
            records.append(ConformanceRecord(
                dataflow=spec.name, movement=movement,
                source="block_schedule", point=pt,
                analytical_bytes=float(out[movement].data_bits) / 8.0,
                measured_bytes=traced["bytes"],
                tolerance=EXACT_REL_TOL))

    # Off-chip total: every L2-class level must be covered by some stream.
    records.append(ConformanceRecord(
        dataflow=spec.name, movement="hbm_total", source="block_schedule",
        point=pt, analytical_bytes=float(out.offchip_bits()) / 8.0,
        measured_bytes=sum(m["stream_total_bytes"] for m in measures),
        tolerance=EXACT_REL_TOL))

    # Launch boundary: the tensors a launch is given must be exactly the
    # block cover of its declared streams.
    for meas in measures:
        records.append(ConformanceRecord(
            dataflow=spec.name, movement=f"boundary_{meas['label']}",
            source="launch_boundary", point=pt,
            analytical_bytes=meas["distinct_total_bytes"],
            measured_bytes=meas["boundary_bytes"],
            tolerance=EXACT_REL_TOL))

    # Single-device programs move no collective bytes; the record keeps the
    # ledger's hook live for sharded kernels.
    records.append(ConformanceRecord(
        dataflow=spec.name, movement="collective_wire",
        source="collective_ledger", point=pt, analytical_bytes=0.0,
        measured_bytes=sum(m["collective_wire_bytes"] for m in measures),
        tolerance=0.0))
    return records


def interphase_delta(point: OperatingPoint, *, device=None,
                     fused_measures: list[dict] | None = None,
                     unfused_measures: list[dict] | None = None
                     ) -> list[ConformanceRecord]:
    """Unfused-minus-fused measured bytes == the eliminated inter-phase
    terms ``K*N*sigma`` write + ``P_s*N*sigma`` read (``P_s = K``), at the
    launch boundary and in the traced schedule."""
    from . import registry

    fused_spec = registry.get("spmm_tiled_cta")
    unfused_spec = registry.get("spmm_unfused_cta")
    unf_analogue = unfused_spec.runnable_analogue()
    fused, unfused = fused_measures, unfused_measures
    if fused is None:
        fused = measure_analogue(fused_spec.runnable_analogue(), point,
                                 resolve_device(device))
    if unfused is None:
        unfused = measure_analogue(unf_analogue, point,
                                   resolve_device(device))
    graph, hw = unf_analogue.graph_hw(unfused_spec, point)
    out = unfused_spec.evaluate(graph, hw)
    eliminated = (float(out["writeinterphase"].data_bits)
                  + float(out["readinterphase"].data_bits)) / 8.0
    pt = point.as_dict()

    def _delta(key: Callable[[dict], float]) -> float:
        return sum(key(m) for m in unfused) - sum(key(m) for m in fused)

    return [
        ConformanceRecord(
            dataflow="spmm_unfused_cta", movement="interphase_delta",
            source="launch_boundary", point=pt, analytical_bytes=eliminated,
            measured_bytes=_delta(lambda m: m["boundary_bytes"]),
            tolerance=EXACT_REL_TOL),
        ConformanceRecord(
            dataflow="spmm_unfused_cta", movement="interphase_delta",
            source="block_schedule", point=pt, analytical_bytes=eliminated,
            measured_bytes=_delta(lambda m: m["stream_total_bytes"]),
            tolerance=EXACT_REL_TOL),
    ]


def _preflight_audit(names: Sequence[str]) -> None:
    """The static-audit gate: each named dataflow, and the kernel spec its
    analogue is held to, must audit strict-clean; the first that does not
    raises ``AssertionError`` before anything is measured or launched."""
    from ..analysis import audit_spec
    from . import registry

    for name in names:
        spec = registry.get(name)
        checked = [spec]
        if spec.has_runnable:
            checked.append(registry.get(spec.runnable_analogue().dataflow))
        for s in checked:
            errors = audit_spec(s).strict_errors()
            if errors:
                raise AssertionError(
                    f"static model audit failure for {s.name!r}; refusing "
                    "to measure (rerun with preflight_audit=False to "
                    "override): " + "; ".join(errors))


def run_conformance(names: Sequence[str] | None = None,
                    points: Sequence[OperatingPoint] | None = None, *,
                    device=None, preflight_audit: bool = True
                    ) -> list[ConformanceRecord]:
    """The harness: every named runnable dataflow (default: both, K1 and
    K2 + K3) at every point, plus the inter-phase delta when both run.

    With ``preflight_audit`` (the default) every named dataflow and the
    kernel spec it is held to first pass the static model auditor
    (:func:`_preflight_audit`): a model whose closed forms fail the
    unit / provenance / golden audit is refused before any launch tensor
    is allocated on ``device``.
    """
    from . import registry

    names = (registry.runnable_names() if names is None
             else tuple(names))
    if preflight_audit:
        _preflight_audit(names)
    analogues = {name: registry.get(name).runnable_analogue()
                 for name in names}
    dev = resolve_device(device)
    points = operating_points() if points is None else points
    records: list[ConformanceRecord] = []
    for pt in points:
        measured = {}
        for name, analogue in analogues.items():
            measured[name] = measure_analogue(analogue, pt, dev)
            records.extend(conformance_records(registry.get(name), pt,
                                               measures=measured[name]))
        if {"spmm_tiled", "spmm_unfused"} <= set(names):
            records.extend(interphase_delta(
                pt, fused_measures=measured["spmm_tiled"],
                unfused_measures=measured["spmm_unfused"]))
    return records


def verify_numerics(point: OperatingPoint, *, seed: int = 0,
                    device=None) -> float:
    """Run the fused kernel and the unfused pair at a point against the
    fp32 plain oracle on the chosen device; returns the max relative error
    (the measured programs must compute the right thing, not only move the
    right bytes)."""
    from ..kernels import ops
    from ..kernels.ref import fused_aggregate_combine_ref

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K, N, T = point.K, point.N, point.T
    a = torch.as_tensor((rng.random((K, K)) < 0.05) * rng.random((K, K)),
                        dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.standard_normal((K, N)), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.standard_normal((N, T)), dtype=torch.float32,
                        device=dev)
    expect = fused_aggregate_combine_ref(a, x, w)
    fused = ops.gnn_aggregate_combine(a, x, w, block_n=point.Bn,
                                      block_k=point.Bk)
    unfused = ops.gnn_combine(
        ops.gnn_aggregate(a, x, block_n=point.Bn, block_k=point.Bk),
        w, block_n=point.Bn)
    denom = float(expect.abs().max()) + 1e-9
    return max(float((fused - expect).abs().max()) / denom,
               float((unfused - expect).abs().max()) / denom)


def summarize_records(records: Sequence[ConformanceRecord]) -> dict:
    """Aggregate a record batch into a summary."""
    by_flow: dict[str, dict] = {}
    for r in records:
        e = by_flow.setdefault(r.dataflow, {"n_records": 0, "n_ok": 0,
                                            "max_abs_rel_err": 0.0})
        e["n_records"] += 1
        e["n_ok"] += int(r.ok)
        if not r.one_sided and np.isfinite(r.ratio):
            e["max_abs_rel_err"] = max(e["max_abs_rel_err"],
                                       abs(r.ratio - 1.0))
    return {
        "n_records": len(records),
        "n_ok": sum(int(r.ok) for r in records),
        "all_ok": all(r.ok for r in records),
        "by_dataflow": by_flow,
    }


def main(argv=None) -> int:
    """Print one CSV row per record; exit 1 on any violation."""
    import argparse
    import csv
    import io
    import json
    import sys
    import time

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.conformance",
        description="Hold the port's GNN layer kernels to their closed forms.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the launch tensors live and --execute runs "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--points", type=int, default=None, metavar="M",
                    help="truncate the twelve-point sweep to M points")
    ap.add_argument("--execute", action="store_true",
                    help="also run the kernels against the fp32 oracle at "
                         "each point")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the records and summary as JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    points = operating_points()
    if args.points is not None:
        points = points[:args.points]

    t0 = time.perf_counter()
    records = run_conformance(points=points, device=device)
    elapsed = time.perf_counter() - t0

    rows = [r.as_row() for r in records]
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=sorted({k for r in rows for k in r}))
    writer.writeheader()
    writer.writerows(rows)
    print(f"# ==== port conformance on {device} ({len(rows)} records, "
          f"{len(points)} operating points) ====")
    print(buf.getvalue())

    numerics = None
    if args.execute:
        numerics = max(verify_numerics(pt, device=device) for pt in points)
        print(f"# numerics max relative error vs fp32 oracle: "
              f"{numerics:.3e} (tolerance {NUMERICS_REL_TOL:.0e})")

    summary = summarize_records(records)
    summary["elapsed_s"] = elapsed
    summary["device"] = str(device)
    if numerics is not None:
        summary["numerics_max_rel_err"] = numerics
    print(f"# summary: {json.dumps(summary['by_dataflow'], sort_keys=True)}")
    if args.json is not None:
        with open(args.json, "w") as f:
            json.dump({"conformance": summary, "records": rows}, f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.json} ({len(rows)} records)")

    if not summary["all_ok"]:
        failing = [str(r) for r in records if not r.ok]
        print("# CONFORMANCE FAILURES:", *failing, sep="\n# ", file=sys.stderr)
        return 1
    if numerics is not None and not numerics < NUMERICS_REL_TOL:
        print(f"# NUMERICS FAILURE: max relative error {numerics:.3e} "
              f">= {NUMERICS_REL_TOL:.0e}", file=sys.stderr)
        return 1
    print("# all conformance records within declared tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
