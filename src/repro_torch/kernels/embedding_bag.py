"""K6: the embedding bag, ``(B, D)`` sums of rows of a ``(V, D)`` table.

The reference's Pallas kernel walks a grid ``(B, hot)`` on a TPU with the
ids scalar-prefetched: each step DMAs the one ``(1, D)`` table row an id
picks and adds it into the bag's output block, in the table's own dtype.  On
the H100 (``csrc/embedding_bag.cu``) one warp owns one bag and walks its ids
itself, each lane reading 16 bytes of the row at a time; a block holds
:data:`BAGS_PER_BLOCK` bags.  :func:`bag_geometry` is the one description of
that geometry, and the launch reads it.

The sum is sequential and in the table's dtype, rows ``h = 0 .. hot - 1``
added in order into zeros with bf16 rounded after every addition, as the
TPU kernel adds.  So the kernel, its plain version
:func:`embedding_bag_plain` and the reference kernel agree bit for bit in
f32 and in bf16.  (The reference's ``embedding_bag_ref``, take then sum,
rounds otherwise in bf16.)

:func:`embedding_bag` launches the kernel on CUDA tensors and raises for any
other; :func:`embedding_bag_plain` is the plain version that the CPU path
and the card-side comparison use.  Neither has a backward: the TPU kernel
has none, and both raise when autograd would need one.  Training reaches K6
through ``ops.embedding_bag_autograd``, whose ``autograd.Function`` runs
the forward with grad mode off and gives the table its gradient in plain
PyTorch (the transposed gather).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import build
from .edge_aggregate import DTYPE_CODES, require_cuda

__all__ = ["BAGS_PER_BLOCK", "BagGeometry", "bag_geometry",
           "check_bag_operands", "embedding_bag", "embedding_bag_plain"]

#: Bags (warps) per block of 256 threads.
BAGS_PER_BLOCK = 8
#: Bytes one lane loads at a time.
VECTOR_BYTES = 16


@dataclass(frozen=True)
class BagGeometry:
    """The launch of one call: ``vec`` values of the row per lane load (1
    where a row does not start on a 16-byte boundary), the lanes of a warp
    that hold columns of the row, the bags of a block, and the grid."""

    vec: int
    lanes_per_row: int
    bags_per_block: int
    grid: int


def bag_geometry(b: int, d: int, itemsize: int, *,
                 aligned: bool = True) -> BagGeometry:
    """Geometry of ``b`` bags of width ``d`` in a dtype of ``itemsize``
    bytes.  ``aligned`` says the table and output start on 16-byte
    boundaries and the output's row stride is a multiple of the vector."""
    wide = VECTOR_BYTES // itemsize
    vec = wide if aligned and d % wide == 0 else 1
    return BagGeometry(vec=vec, lanes_per_row=min(32, -(-d // vec)),
                       bags_per_block=BAGS_PER_BLOCK,
                       grid=-(-b // BAGS_PER_BLOCK))


def check_bag_operands(table: torch.Tensor, indices: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> None:
    """A contiguous f32 or bf16 ``(V, D)`` table; ``(B, hot)`` int32 ids,
    ``B >= 1`` and ``hot >= 1``, unit column stride; an ``out`` of ``(B, D)``
    in the table's dtype and device with unit column stride; and no input
    that autograd would need a gradient of."""
    if torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("embedding_bag has no backward (the TPU kernel has "
                         "none); call it under torch.inference_mode()")
    if table.dtype not in DTYPE_CODES:
        raise ValueError(f"table dtype {table.dtype} not supported; expected "
                         f"one of {list(DTYPE_CODES)}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"expected a contiguous (V, D) table, got shape "
                         f"{tuple(table.shape)}")
    if indices.dtype != torch.int32:
        raise ValueError(f"ids must be int32 (the reference's), got "
                         f"{indices.dtype}")
    if indices.dim() != 2:
        raise ValueError(f"expected (B, hot) ids, got {tuple(indices.shape)}")
    b, hot = indices.shape
    if b < 1 or hot < 1:
        raise ValueError(f"expected B >= 1 bags of hot >= 1 ids, got "
                         f"{tuple(indices.shape)}")
    if hot > 1 and indices.stride(1) != 1:
        raise ValueError("the ids of a bag must be contiguous (unit column "
                         "stride)")
    if indices.device != table.device:
        raise ValueError(f"ids on {indices.device}, table on {table.device}")
    if out is not None:
        if (tuple(out.shape) != (b, table.shape[1]) or out.dtype != table.dtype
                or out.device != table.device
                or (out.shape[1] > 1 and out.stride(1) != 1)):
            raise ValueError(f"out must be ({b}, {table.shape[1]}) "
                             f"{table.dtype} on {table.device} with unit "
                             f"column stride, got {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 on the card: row ``i`` of the result is the sum of
    ``table[indices[i, h]]`` over ``h``, in the table's dtype; written into
    ``out`` (a strided ``(B, D)`` view may be given) or a new tensor.

    Launches on the current stream and does not synchronise.  An id outside
    ``[0, V)`` traps on the card, which ends the CUDA context.
    """
    require_cuda(table, "embedding_bag")
    check_bag_operands(table, indices, out)
    (v, d), (b, hot) = table.shape, indices.shape
    if out is None:
        out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    out_stride = out.stride(0)
    itemsize = table.element_size()
    wide = VECTOR_BYTES // itemsize
    aligned = (table.data_ptr() % VECTOR_BYTES == 0
               and out.data_ptr() % VECTOR_BYTES == 0
               and out_stride % wide == 0)
    geo = bag_geometry(b, d, itemsize, aligned=aligned)
    lib = build.library("embedding_bag")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        build.check(lib.embedding_bag(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(), v, d, b, hot,
            indices.stride(0), out_stride, geo.vec, geo.bags_per_block,
            geo.grid, DTYPE_CODES[table.dtype], stream), "embedding_bag")
    return out


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order: zeros,
    then ``+ table[indices[:, h]]`` for ``h = 0 .. hot - 1`` in the table's
    dtype.  An id outside ``[0, V)`` raises ``IndexError``."""
    check_bag_operands(table, indices, out)
    ids = indices.long()
    if bool(((ids < 0) | (ids >= table.shape[0])).any()):
        raise IndexError(f"an id lies outside [0, {table.shape[0]})")
    acc = torch.zeros((indices.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for h in range(indices.shape[1]):
        acc = acc + table[ids[:, h]]
    if out is None:
        return acc
    return out.copy_(acc)
