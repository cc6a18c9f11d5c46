"""K1: the fused GNN aggregate + combine kernel, Y = (A @ X) @ W.

The paper's accelerators split a GNN layer into an aggregation stage and a
combination stage.  HyGCN passes the aggregate through an inter-phase buffer
in memory; EnGN keeps it on the PE array.  This kernel is the EnGN side: the
aggregate of each destination block lives in registers and shared memory
and is multiplied by W before anything is written, so the only output
traffic is the (Bn, T) tile.  :mod:`.edge_aggregate_unfused` is the HyGCN
side.

On the H100 (``csrc/edge_aggregate.cu``) one CTA handles one destination
block of ``Bn`` rows and loops over the source blocks itself; the feature
axis is cut into chunks of ``FC = ACC_ELEMS / Bn`` columns, one register
accumulator each.  :func:`fused_grid_spec` is the one description of that
geometry: the launch reads its grid and chunk width from it, and the
conformance harness (:mod:`repro_torch.core.conformance`) traces the blocks
each CTA moves from it.

:func:`fused_aggregate_combine` launches the kernel on CUDA tensors and
raises for any other; :func:`fused_aggregate_combine_plain` is the plain
version that the CPU path and the card-side comparison use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from . import build
from .ref import fused_aggregate_combine_ref

__all__ = ["DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K", "ACC_ELEMS", "CtaSchedule",
           "feature_chunk", "fused_grid_spec", "fused_block_streams",
           "fused_launch_tensors", "fused_aggregate_combine",
           "fused_aggregate_combine_plain", "DTYPE_CODES"]

DEFAULT_BLOCK_N = 256   # dst nodes per CTA (the paper's K)
DEFAULT_BLOCK_K = 256   # src nodes per source block

#: fp32 accumulator elements per CTA: 256 threads x 32 registers (Bn * FC).
ACC_ELEMS = 8192
#: Destination block heights the CUDA kernels are instantiated for.
BLOCK_N_COMPILED = (16, 32, 64, 128, 256, 512)
#: Source columns staged in shared memory per step; Bk must be a multiple.
STEP_K = 16
#: Dynamic shared memory one block may opt into on sm_90.
MAX_SMEM_BYTES = 232448

#: Type codes of the C entry points; A, X, W share one type.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: One move of a CTA: (operand, (row0, row1), (col0, col1)) in elements.
Move = tuple[str, tuple[int, int], tuple[int, int]]


@dataclass(frozen=True)
class CtaSchedule:
    """Grid of one kernel and the blocks each CTA moves, in its own order.

    ``operands`` maps each tensor of the launch to its shape; ``moves(i)``
    yields every block CTA ``i`` reads or writes, one entry per transfer.
    Nothing carries over between CTAs.
    """

    grid: tuple[int, ...]
    block_n: int
    block_k: int | None
    chunk: int
    smem_bytes: int
    operands: dict[str, tuple[int, int]]
    moves: Callable[[int], Iterator[Move]]


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


def fused_grid_spec(n: int, f: int, t: int, block_n: int,
                    block_k: int) -> CtaSchedule:
    """The fused kernel's CTA geometry: grid ``(n / Bn,)``; CTA ``i`` walks
    the feature chunks, and in each chunk every source block ``j``, loading
    A[i, j] and X[j, chunk]; it loads W's rows of the chunk once per chunk
    and writes its (Bn, T) output tile once."""
    fc = feature_chunk(block_n)
    check_blocks(n, block_n, block_k)
    chunks = chunk_bounds(f, fc)
    smem = 4 * (STEP_K * (block_n + 4 + fc) + block_n * (fc + 1) + fc * t
                + block_n * t)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_n={block_n}, t={t} need {smem} B of shared "
                         f"memory; a CTA has {MAX_SMEM_BYTES}")

    def moves(i: int) -> Iterator[Move]:
        rows = (i * block_n, (i + 1) * block_n)
        for cols in chunks:
            for j in range(n // block_k):
                src = (j * block_k, (j + 1) * block_k)
                yield "a", rows, src
                yield "x", src, cols
            yield "w", cols, (0, t)
        yield "out", rows, (0, t)

    return CtaSchedule(grid=(n // block_n,), block_n=block_n,
                       block_k=block_k, chunk=fc, smem_bytes=smem,
                       operands={"a": (n, n), "x": (n, f), "w": (f, t),
                                 "out": (n, t)},
                       moves=moves)


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.fused_aggregate_combine(
            a.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, f, w.shape[1], sched.block_n, sched.block_k, sched.chunk,
            DTYPE_CODES[x.dtype], stream), "fused_aggregate_combine")
    return out


#: The plain version of K1 is the oracle itself.
fused_aggregate_combine_plain = fused_aggregate_combine_ref
