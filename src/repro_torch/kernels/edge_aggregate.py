"""K1: the fused GNN aggregate + combine kernel, Y = (A @ X) @ W.

The paper's accelerators split a GNN layer into an aggregation stage and a
combination stage.  HyGCN passes the aggregate through an inter-phase buffer
in memory; EnGN keeps it on the PE array.  This kernel is the EnGN side: the
aggregate of each destination block lives in registers and shared memory
and is multiplied by W before anything is written, so the only output
traffic is the (Bn, T) tile.  :mod:`.edge_aggregate_unfused` is the HyGCN
side.

On the H100 (``csrc/edge_aggregate.cu``, ``csrc/aggregate_hopper.cuh``)
the feature axis is cut into chunks of ``FC = ACC_ELEMS / Bn`` columns, and
a destination block of ``Bn`` rows is spread over the CTAs ("ranks") of a
thread block cluster: one rank per feature chunk, or, where there is one
chunk, one rank per run of source blocks, summed in distributed shared
memory.  :func:`fused_grid_spec` is the one description of that geometry:
the launch's grid and chunk width come from it (the wrapper holds the C
side's rank count to it), and the conformance harness
(:mod:`repro_torch.core.conformance`) traces the blocks each CTA moves from
it.

:func:`fused_aggregate_combine` launches the kernel on CUDA tensors and
raises for any other; :func:`fused_aggregate_combine_plain` is the plain
version that the CPU path and the card-side comparison use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from . import build
from .ref import fused_aggregate_combine_ref

__all__ = ["DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K", "ACC_ELEMS", "CtaSchedule",
           "feature_chunk", "cta_plan", "source_range", "fused_grid_spec",
           "fused_block_streams", "fused_launch_tensors",
           "fused_aggregate_combine", "fused_aggregate_combine_plain",
           "DTYPE_CODES"]

DEFAULT_BLOCK_N = 256   # dst nodes per CTA (the paper's K)
DEFAULT_BLOCK_K = 256   # src nodes per source block

#: Elements of one (Bn, FC) tile of the aggregate: Bn * FC.
ACC_ELEMS = 8192
#: Destination block heights the CUDA kernels are instantiated for.
BLOCK_N_COMPILED = (16, 32, 64, 128, 256, 512)
#: Bk must be a multiple of this many source columns.
STEP_K = 16
#: Dynamic shared memory one block may opt into on sm_90.
MAX_SMEM_BYTES = 232448
#: SMs of an H100 SXM, which the ranks of a one-chunk layer fill.
SMS = 132
#: The largest portable thread block cluster.
MAX_CLUSTER = 8
#: A rank's share of the source axis is a multiple of this many sources
#: (whole source blocks): one ring stage holds 32 f32 or 64 bf16 of them.
SPLIT_SOURCES = 64
#: Ring stages of the aggregation kernel, at most (aggregate_hopper.cuh).
MAX_STAGES = 8

#: Type codes of the C entry points; A, X, W share one type.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: One move of a CTA: (operand, (row0, row1), (col0, col1)) in elements.
Move = tuple[str, tuple[int, int], tuple[int, int]]


@dataclass(frozen=True)
class CtaSchedule:
    """Grid of one kernel and the blocks each CTA moves, in its own order.

    ``operands`` maps each tensor of the launch to its shape; ``moves(i)``
    yields every block CTA ``i`` (flat, first grid axis fastest) reads or
    writes, one entry per transfer.  ``cluster`` CTAs along the first axis
    form a thread block cluster; nothing carries over between clusters.
    """

    grid: tuple[int, ...]
    block_n: int
    block_k: int | None
    chunk: int
    smem_bytes: int
    operands: dict[str, tuple[int, int]]
    moves: Callable[[int], Iterator[Move]]
    cluster: int = 1


def feature_chunk(block_n: int) -> int:
    """Feature columns per accumulator chunk, ``FC = ACC_ELEMS / Bn``."""
    if block_n not in BLOCK_N_COMPILED:
        raise ValueError(f"block_n={block_n} is not one of the destination "
                         f"block heights the kernels are compiled for, "
                         f"{BLOCK_N_COMPILED} (the CTA holds a {ACC_ELEMS}-"
                         "element fp32 accumulator in 8x4 thread tiles)")
    return ACC_ELEMS // block_n


def chunk_bounds(f: int, fc: int) -> list[tuple[int, int]]:
    return [(c0, min(f, c0 + fc)) for c0 in range(0, f, fc)]


def check_blocks(n: int, block_n: int, block_k: int) -> None:
    if n % block_n or n % block_k:
        raise ValueError(f"n={n} must divide into block_n={block_n} and "
                         f"block_k={block_k} blocks; pad the graph")
    if block_k % STEP_K:
        raise ValueError(f"block_k={block_k} must be a multiple of {STEP_K}")


def cta_plan(n: int, f: int, block_n: int, block_k: int,
             fused: bool) -> tuple[int, bool, int]:
    """``(ranks, split_sources, cluster)`` of a destination block, the rule
    of ``plan()`` in ``csrc/aggregate_hopper.cuh``.

    With several feature chunks the ranks take whole chunks: K1 one rank per
    chunk, up to a cluster of 8 (rank r takes chunks r, r + 8, ...); K2 one
    CTA per chunk, with no cluster.  With one chunk the ranks split the
    source blocks, in units of whole blocks of at least ``SPLIT_SOURCES``
    sources: the most ranks, a power of two, at most 8 and one per unit,
    that keep every CTA in one wave on the SMs (clusters of 3 or 6 leave SMs
    idle on the H100).
    """
    nfc = math.ceil(f / feature_chunk(block_n))
    if nfc > 1:
        ranks = min(nfc, MAX_CLUSTER) if fused else nfc
        return ranks, False, ranks if fused else 1
    units = math.ceil((n // block_k) / _unit_blocks(block_k))
    ranks = 1
    while (2 * ranks <= min(units, MAX_CLUSTER)
           and 2 * ranks * (n // block_n) <= SMS):
        ranks *= 2
    return ranks, True, ranks


def _unit_blocks(block_k: int) -> int:
    return SPLIT_SOURCES // math.gcd(block_k, SPLIT_SOURCES)


def source_range(n: int, block_k: int, ranks: int, r: int) -> tuple[int, int]:
    """Sources ``[lo, hi)`` of rank ``r`` when the ranks split the source
    blocks: whole units, the first ``units % ranks`` ranks one more."""
    g, nbk = _unit_blocks(block_k), n // block_k
    units = math.ceil(nbk / g)
    base, extra = divmod(units, ranks)
    u0 = r * base + min(r, extra)
    u1 = u0 + base + (1 if r < extra else 0)
    return min(u0 * g, nbk) * block_k, min(u1 * g, nbk) * block_k


def kernel_smem_bytes(block_n: int, fused: bool, t: int = 0,
                      alias: bool = False) -> int:
    """Shared memory of one aggregation CTA, the larger of f32 and bf16
    (``Geo`` in ``csrc/aggregate_hopper.cuh``): the ring at the most stages
    that fit, the staged (Bn, FC) aggregate (in the ring's place when
    ``alias``: every CTA has one chunk), and for K1 the (Bn, T) partial.  A
    stage holds A's tile of 128-byte rows (64 for f32 at Bn = 512), its f32
    lo tile, and X's tile in boxes of at most 128 bytes a row, one box more
    than the chunk needs (X's rows may start off a 16-byte boundary, and TMA
    boxes may not).  Raises if two stages do not fit."""
    fc = feature_chunk(block_n)
    agg = 4 * block_n * (fc + 4)
    rest = 1024 + (4 * block_n * t if fused else 0)
    sizes = []
    for elem in (4, 2):
        a_row = 64 if elem == 4 and block_n >= 512 else 128
        kt = a_row // elem
        box_cols = fc if fc * elem < 128 else 128 // elem
        box_stride = kt * box_cols * elem
        x_off = block_n * a_row * (2 if elem == 4 else 1)
        boxes = max(fc, 64) // box_cols + 1   # one more for a row's lead
        stage = -(-(x_off + boxes * box_stride) // 1024) * 1024
        fits = [rest + s * 24 + (max(s * stage, agg) if alias
                                 else s * stage + agg)
                for s in range(MAX_STAGES, 1, -1)]
        fits = [b for b in fits if b <= MAX_SMEM_BYTES]
        if not fits:
            raise ValueError(f"block_n={block_n}, t={t} need more than "
                             f"{MAX_SMEM_BYTES} B of shared memory for two "
                             "ring stages")
        sizes.append(fits[0])
    return max(sizes)


def rank_work(n: int, f: int, block_n: int, block_k: int, fused: bool):
    """Per rank ``r``: its feature chunks and its source blocks."""
    fc = feature_chunk(block_n)
    chunks = chunk_bounds(f, fc)
    ranks, split_sources, cluster = cta_plan(n, f, block_n, block_k, fused)

    def work(r: int) -> tuple[list, list]:
        if split_sources:
            lo, hi = source_range(n, block_k, ranks, r)
            return chunks, [(j, j + block_k) for j in range(lo, hi, block_k)]
        return (chunks[r::ranks],
                [(j, j + block_k) for j in range(0, n, block_k)])

    return ranks, split_sources, cluster, work


def fused_grid_spec(n: int, f: int, t: int, block_n: int,
                    block_k: int) -> CtaSchedule:
    """The fused kernel's CTA geometry: grid ``(ranks, n / Bn)``, clusters
    of ``ranks`` along the first axis.  Rank ``r`` of destination block
    ``i`` walks its feature chunks and in each its source blocks ``j``,
    loading A[i, j] and X[j, chunk]; with several chunks it loads W's rows
    of each of its chunks, with one the leader loads them; the leader
    writes the (Bn, T) output tile once.  Per destination block that is
    each chunk's A and X blocks once, W once and the output once."""
    fc = feature_chunk(block_n)
    check_blocks(n, block_n, block_k)
    ranks, split_sources, cluster, work = rank_work(n, f, block_n, block_k,
                                                     True)
    smem = kernel_smem_bytes(block_n, True, t,
                             split_sources or ranks * fc >= f)

    def moves(i: int) -> Iterator[Move]:
        b, r = divmod(i, ranks)
        rows = (b * block_n, (b + 1) * block_n)
        chunks, sources = work(r)
        for cols in chunks:
            for src in sources:
                yield "a", rows, src
                yield "x", src, cols
            if not split_sources or r == 0:
                yield "w", cols, (0, t)
        if r == 0:
            yield "out", rows, (0, t)

    return CtaSchedule(grid=(ranks, n // block_n), block_n=block_n,
                       block_k=block_k, chunk=fc, smem_bytes=smem,
                       operands={"a": (n, n), "x": (n, f), "w": (f, t),
                                 "out": (n, t)},
                       moves=moves, cluster=cluster)


def fused_block_streams(n: int, f: int, t: int, *,
                        block_n: int = DEFAULT_BLOCK_N,
                        block_k: int = DEFAULT_BLOCK_K,
                        elem_bytes: float = 4.0) -> dict:
    """Movement-level-named streams of the fused kernel.

    Keys match the ``spmm_tiled_cta`` port spec's off-chip movement levels;
    each names the operand whose moves it counts.
    """
    sched = fused_grid_spec(n, f, t, block_n, block_k)
    return {
        "schedule": sched,
        "streams": {
            "loadadjblocks": {"operand": "a", "elem_bytes": elem_bytes,
                              "kind": "read"},
            "loadvertblocks": {"operand": "x", "elem_bytes": elem_bytes,
                               "kind": "read"},
            "loadweights": {"operand": "w", "elem_bytes": elem_bytes,
                            "kind": "read"},
            "writeout": {"operand": "out", "elem_bytes": elem_bytes,
                         "kind": "write"},
        },
    }


def check_operands(*tensors: torch.Tensor) -> None:
    """One dtype (f32 or bf16), one device, 2-D and contiguous."""
    dtype, device = tensors[0].dtype, tensors[0].device
    for v in tensors:
        if v.dtype != dtype or v.device != device:
            raise ValueError("operands must share one dtype and device; got "
                             f"{[(u.dtype, str(u.device)) for u in tensors]}")
        if v.dim() != 2 or not v.is_contiguous():
            raise ValueError(f"operands must be contiguous 2-D tensors; got "
                             f"shape {tuple(v.shape)}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {dtype} not supported; expected one of "
                         f"{list(DTYPE_CODES)}")


def fused_launch_tensors(adjacency: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, *, block_n: int = DEFAULT_BLOCK_N,
                         block_k: int = DEFAULT_BLOCK_K
                         ) -> tuple[CtaSchedule, tuple[torch.Tensor, ...]]:
    """Validate, clamp the blocks to ``n`` and allocate the output: the
    schedule and every tensor the launch is given, output last."""
    check_operands(adjacency, x, w)
    n, f = x.shape
    t = w.shape[1]
    if adjacency.shape != (n, n) or w.shape[0] != f:
        raise ValueError(f"shapes A {tuple(adjacency.shape)}, X "
                         f"{tuple(x.shape)}, W {tuple(w.shape)} do not chain")
    sched = fused_grid_spec(n, f, t, min(block_n, n), min(block_k, n))
    out = torch.empty((n, t), dtype=x.dtype, device=x.device)
    return sched, (adjacency, x, w, out)


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel and needs CUDA "
                         f"tensors, got {t.device}; the ops wrappers take the "
                         "plain version for CPU tensors")


def check_ranks(ranks: int, sched: CtaSchedule, what: str) -> None:
    """The C side's ranks per destination block must be the schedule's."""
    if ranks != sched.grid[0]:
        raise RuntimeError(f"{what}: the kernel would launch {ranks} ranks "
                           f"per destination block, its schedule "
                           f"{sched.grid[0]}")


def require_aligned(adjacency: torch.Tensor, x: torch.Tensor) -> None:
    """TMA reads A and X, which must start on 16 bytes."""
    if adjacency.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("A and X must start on a 16-byte boundary (the "
                         "kernel reads them by TMA); pass fresh tensors")


def fused_aggregate_combine(adjacency: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor, *,
                            block_n: int = DEFAULT_BLOCK_N,
                            block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """K1 on the card: Y = (A @ X) @ W, A (n, n) block-dense, X (n, f),
    W (f, t); fp32 accumulation, output in ``x.dtype``.

    ``n`` must divide into the (clamped) blocks: the caller pads the graph.
    Launches on the current stream and does not synchronise.
    """
    require_cuda(x, "fused_aggregate_combine")
    sched, (a, x, w, out) = fused_launch_tensors(
        adjacency, x, w, block_n=block_n, block_k=block_k)
    n, f = x.shape
    lib = build.library("edge_aggregate")
    check_ranks(lib.fused_ranks(n, f, sched.block_n, sched.block_k,
                                sched.chunk), sched, "fused_aggregate_combine")
    require_aligned(a, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.fused_aggregate_combine(
            a.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, f, w.shape[1], sched.block_n, sched.block_k, sched.chunk,
            DTYPE_CODES[x.dtype], stream), "fused_aggregate_combine")
    return out


#: The plain version of K1 is the oracle itself.
fused_aggregate_combine_plain = fused_aggregate_combine_ref
