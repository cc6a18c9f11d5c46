"""K2 + K3: the unfused two-pass GNN layer, HyGCN's inter-phase analogue.

The same block-dense SpMM as :mod:`.edge_aggregate`, but aggregation and
combination are two kernels with the (n, f) aggregate in device memory
between them (``csrc/edge_aggregate_unfused.cu``):

* pass 1, :func:`aggregate_pass` (K2): Y_agg = A @ X over grid
  ``(ranks, n/Bn)``, one CTA per (destination block, feature chunk), or,
  with one chunk, a cluster whose ranks split the source blocks as the
  fused kernel's do, so both read the same A and X bytes; each chunk of the
  aggregate is spilled once, rounded to the input type;
* pass 2, :func:`combine_pass` (K3): Y = Y_agg @ W over grid
  ``(ranks, n/Bn)``, reading the spill back: a destination block's feature
  chunks spread over the ranks of a cluster (rank r takes chunks r, r + 8,
  ... and their rows of W), whose leader sums the (Bn, T) partials and
  writes the tile once; with one chunk, one CTA a block.

The passes stay two launches: joined into one program, the round trip they
exist to measure would disappear.  The fused-minus-unfused traffic is then
exactly the ``writeinterphase + readinterphase`` terms of the
``spmm_unfused_cta`` port spec, which the conformance harness checks from
the ``*_grid_spec`` geometry below.
"""

from __future__ import annotations

import math
from typing import Iterator

import torch

from . import build
from .edge_aggregate import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_N, DTYPE_CODES,
                             MAX_CLUSTER, MAX_SMEM_BYTES, CtaSchedule, Move,
                             rank_work, check_blocks, check_ranks, chunk_bounds,
                             check_operands, feature_chunk,
                             kernel_smem_bytes, require_aligned,
                             require_cuda)
from ..backend import full_fp32

__all__ = ["aggregate_grid_spec", "combine_grid_spec", "combine_plan",
           "combine_smem_bytes",
           "aggregate_block_streams", "combine_block_streams",
           "aggregate_launch_tensors", "combine_launch_tensors",
           "aggregate_pass", "combine_pass", "unfused_aggregate_combine",
           "aggregate_pass_plain", "combine_pass_plain"]


def aggregate_grid_spec(n: int, f: int, block_n: int,
                        block_k: int) -> CtaSchedule:
    """Grid ``(ranks, n / Bn)``.  With several feature chunks CTA ``(c, i)``
    walks every source block of chunk ``c`` and spills its (Bn, chunk) tile
    once (no cluster); with one chunk the ranks of a cluster split the
    source blocks, and the leader spills the summed tile once."""
    fc = feature_chunk(block_n)
    check_blocks(n, block_n, block_k)
    ranks, split_sources, cluster, work = rank_work(n, f, block_n, block_k,
                                                     False)
    smem = kernel_smem_bytes(block_n, False, alias=True)

    def moves(i: int) -> Iterator[Move]:
        b, r = divmod(i, ranks)
        rows = (b * block_n, (b + 1) * block_n)
        chunks, sources = work(r)
        for cols in chunks:
            for src in sources:
                yield "a", rows, src
                yield "x", src, cols
            if not split_sources or r == 0:
                yield "y", rows, cols

    return CtaSchedule(grid=(ranks, n // block_n), block_n=block_n,
                       block_k=block_k, chunk=fc, smem_bytes=smem,
                       operands={"a": (n, n), "x": (n, f), "y": (n, f)},
                       moves=moves, cluster=cluster)


def combine_plan(f: int, block_n: int) -> tuple[int, int]:
    """``(ranks, cluster)`` of a destination block in the combine, the rule
    of ``combine_plan()`` in ``csrc/edge_aggregate_unfused.cu``: one rank per
    feature chunk, at most a cluster of 8 (rank r takes chunks r, r + 8,
    ...); one chunk is one CTA and no cluster."""
    ranks = min(math.ceil(f / feature_chunk(block_n)), MAX_CLUSTER)
    return ranks, ranks if ranks > 1 else 1


def combine_smem_bytes(block_n: int, t: int) -> int:
    """Shared memory of one combine CTA (``CombineGeo`` in
    ``csrc/edge_aggregate_unfused.cu``): W's chunk rows (at least 32) in one
    block of TB output columns (TB = 8, 16 or 32), each padded to TB + 4
    floats, and the (Bn, T) fp32 partial."""
    fc = feature_chunk(block_n)
    tb = 8 if t <= 8 else 16 if t <= 16 else 32
    return 4 * (max(fc, 32) * (tb + 4) + block_n * t)


def combine_grid_spec(n: int, f: int, t: int, block_n: int) -> CtaSchedule:
    """Grid ``(ranks, n / Bn)``, clusters of ``ranks`` along the first axis.
    Rank ``r`` of destination block ``i`` reads the aggregate rows and W's
    rows of its chunks (r, r + ranks, ...), each once; the leader writes the
    (Bn, T) output tile once.  Per destination block that is its (Bn, F)
    rows once, W once and the tile once, as with one CTA a block."""
    fc = feature_chunk(block_n)
    check_blocks(n, block_n, block_n)
    chunks = chunk_bounds(f, fc)
    ranks, cluster = combine_plan(f, block_n)
    smem = combine_smem_bytes(block_n, t)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_n={block_n}, t={t} need {smem} B of shared "
                         f"memory; a CTA has {MAX_SMEM_BYTES}")

    def moves(i: int) -> Iterator[Move]:
        b, r = divmod(i, ranks)
        rows = (b * block_n, (b + 1) * block_n)
        for cols in chunks[r::ranks]:
            yield "y", rows, cols
            yield "w", cols, (0, t)
        if r == 0:
            yield "out", rows, (0, t)

    return CtaSchedule(grid=(ranks, n // block_n), block_n=block_n,
                       block_k=None, chunk=fc, smem_bytes=smem,
                       operands={"y": (n, f), "w": (f, t), "out": (n, t)},
                       moves=moves, cluster=cluster)


def aggregate_block_streams(n: int, f: int, *,
                            block_n: int = DEFAULT_BLOCK_N,
                            block_k: int = DEFAULT_BLOCK_K,
                            elem_bytes: float = 4.0) -> dict:
    """Movement-level-named streams of the aggregation pass, keyed to the
    ``spmm_unfused_cta`` port spec."""
    sched = aggregate_grid_spec(n, f, block_n, block_k)
    return {
        "schedule": sched,
        "streams": {
            "loadadjblocks": {"operand": "a", "elem_bytes": elem_bytes,
                              "kind": "read"},
            "loadvertblocks": {"operand": "x", "elem_bytes": elem_bytes,
                               "kind": "read"},
            "writeinterphase": {"operand": "y", "elem_bytes": elem_bytes,
                                "kind": "write"},
        },
    }


def combine_block_streams(n: int, f: int, t: int, *,
                          block_n: int = DEFAULT_BLOCK_N,
                          elem_bytes: float = 4.0) -> dict:
    """Movement-level-named streams of the combination pass."""
    sched = combine_grid_spec(n, f, t, block_n)
    return {
        "schedule": sched,
        "streams": {
            "readinterphase": {"operand": "y", "elem_bytes": elem_bytes,
                               "kind": "read"},
            "loadweights": {"operand": "w", "elem_bytes": elem_bytes,
                            "kind": "read"},
            "writeout": {"operand": "out", "elem_bytes": elem_bytes,
                         "kind": "write"},
        },
    }


def aggregate_launch_tensors(adjacency: torch.Tensor, x: torch.Tensor, *,
                             block_n: int = DEFAULT_BLOCK_N,
                             block_k: int = DEFAULT_BLOCK_K
                             ) -> tuple[CtaSchedule, tuple[torch.Tensor, ...]]:
    """Validate and allocate: the schedule and the launch's tensors
    ``(A, X, Y_agg)``."""
    check_operands(adjacency, x)
    n, f = x.shape
    if adjacency.shape != (n, n):
        raise ValueError(f"A {tuple(adjacency.shape)} is not ({n}, {n})")
    sched = aggregate_grid_spec(n, f, min(block_n, n), min(block_k, n))
    y = torch.empty((n, f), dtype=x.dtype, device=x.device)
    return sched, (adjacency, x, y)


def combine_launch_tensors(y_agg: torch.Tensor, w: torch.Tensor, *,
                           block_n: int = DEFAULT_BLOCK_N
                           ) -> tuple[CtaSchedule, tuple[torch.Tensor, ...]]:
    """Validate and allocate: the schedule and the launch's tensors
    ``(Y_agg, W, Y)``."""
    check_operands(y_agg, w)
    n, f = y_agg.shape
    if w.shape[0] != f:
        raise ValueError(f"W {tuple(w.shape)} does not take ({n}, {f})")
    sched = combine_grid_spec(n, f, w.shape[1], min(block_n, n))
    out = torch.empty((n, w.shape[1]), dtype=y_agg.dtype,
                      device=y_agg.device)
    return sched, (y_agg, w, out)


def aggregate_pass(adjacency: torch.Tensor, x: torch.Tensor, *,
                   block_n: int = DEFAULT_BLOCK_N,
                   block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """K2 on the card: Y_agg = A @ X, fp32 accumulation, spilled in
    ``x.dtype``.  Launches on the current stream, no synchronisation."""
    require_cuda(x, "aggregate_pass")
    sched, (a, x, y) = aggregate_launch_tensors(adjacency, x,
                                                block_n=block_n,
                                                block_k=block_k)
    n, f = x.shape
    lib = build.library("edge_aggregate_unfused")
    check_ranks(lib.aggregate_ranks(n, f, sched.block_n, sched.block_k,
                                    sched.chunk), sched, "aggregate_pass")
    require_aligned(a, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.aggregate_pass(
            a.data_ptr(), x.data_ptr(), y.data_ptr(), n, f, sched.block_n,
            sched.block_k, sched.chunk, DTYPE_CODES[x.dtype], stream),
            "aggregate_pass")
    return y


def combine_pass(y_agg: torch.Tensor, w: torch.Tensor, *,
                 block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """K3 on the card: Y = Y_agg @ W, fp32 accumulation, output in
    ``y_agg.dtype``.  Launches on the current stream, no synchronisation."""
    require_cuda(y_agg, "combine_pass")
    sched, (y, w, out) = combine_launch_tensors(y_agg, w, block_n=block_n)
    n, f = y.shape
    lib = build.library("edge_aggregate_unfused")
    check_ranks(lib.combine_ranks(n, f, w.shape[1], sched.block_n,
                                  sched.chunk), sched, "combine_pass")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        build.check(lib.combine_pass(
            y.data_ptr(), w.data_ptr(), out.data_ptr(), n, f, w.shape[1],
            sched.block_n, sched.chunk, DTYPE_CODES[y.dtype], stream),
            "combine_pass")
    return out


def unfused_aggregate_combine(adjacency: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, *,
                              block_n: int = DEFAULT_BLOCK_N,
                              block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Two-pass Y = (A @ X) @ W on the card; the aggregate round-trips
    through device memory between the two launches."""
    y_agg = aggregate_pass(adjacency, x, block_n=block_n, block_k=block_k)
    return combine_pass(y_agg, w, block_n=block_n)


def aggregate_pass_plain(adjacency: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: fp32 product, rounded to ``x.dtype``."""
    full_fp32()
    return (adjacency.float() @ x.float()).to(x.dtype)


def combine_pass_plain(y_agg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: fp32 product, rounded to ``y_agg.dtype``."""
    full_fp32()
    return (y_agg.float() @ w.float()).to(y_agg.dtype)
