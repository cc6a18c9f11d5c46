"""Public wrappers of the port's kernels (GNN layer K1-K3, trace K4,
attention K5, embedding bag K6), and K6 under autograd
(:func:`embedding_bag_autograd`).

A CUDA tensor launches the hand-written kernel (or the kernel module
raises); a CPU tensor takes the kernel's plain version.  Nothing falls back
from the card to the CPU.

K5 and K6 are ``torch.library`` ops (``repro_torch::flash_attention``,
``repro_torch::embedding_bag`` and ``embedding_bag_out``), so a dispatch
mode sees them whole: the CUDA implementation launches the kernel, the CPU
one is the plain version, and the fake one gives the output's shape and
dtype and refuses what the kernel refuses, which lets the dry run
(``repro_torch.launch.dryrun``) trace a step under ``FakeTensorMode``.
K5's FLOPs are registered with ``torch.utils.flop_counter`` (4·D a
(query, key) pair the mask admits, per query head); K6 has no formula, as
aten's ``embedding_bag`` has none.

``LAUNCHES`` counts, per kernel, the launches these wrappers made: each
wrapper (for K5 and K6, each op's CUDA implementation) adds one right after
its kernel launched, and nowhere else, so a run can show that its main path
went through the kernels; a fake call launches nothing and counts nothing.  The counts are exact
when several threads launch (the serve engine's dispatcher beside its
callers): every addition holds a lock.  ``K5_LAUNCHES`` counts K5's
launches by dtype, the two kernels it has (``f32``:
``csrc/flash_attention_tf32.cuh``, ``bf16``: ``csrc/flash_attention_hopper.cuh``),
since the module was imported: :func:`reset_launches` leaves it, so a run
can total them and take a path's share as a difference.

The aggregate and combine passes stay two launches, never joined under a
CUDA graph or ``torch.compile``: the pair is the HyGCN inter-phase analogue,
and one program would remove exactly the traffic it models.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import edge_aggregate as ea
from . import edge_aggregate_unfused as eu
from . import embedding_bag as eb
from . import flash_attention as fa
from . import segment_reduce as sr

__all__ = ["LAUNCHES", "K5_LAUNCHES", "reset_launches", "gnn_aggregate_combine",
           "gnn_aggregate", "gnn_combine", "schedule_counts",
           "attention_pairs", "flash_attention", "embedding_bag",
           "EmbeddingBagFunction", "embedding_bag_autograd"]

LAUNCHES = {"edge_aggregate": 0, "edge_aggregate_unfused.aggregate": 0,
            "edge_aggregate_unfused.combine": 0,
            "segment_reduce.schedule_counts": 0, "flash_attention": 0,
            "embedding_bag": 0}
K5_LAUNCHES = {"f32": 0, "bf16": 0}
_K5_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launched(name: str, dtype: Optional[torch.dtype] = None) -> None:
    """Add one launch of kernel ``name`` (of K5's kernel for ``dtype``);
    a read-modify-write: locked."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        if dtype is not None:
            K5_LAUNCHES[_K5_DTYPES[dtype]] += 1


def gnn_aggregate_combine(adjacency: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, *, block_n: int = 256,
                          block_k: int = 256) -> torch.Tensor:
    """Fused Y = (A @ X) @ W (kernel K1 on CUDA)."""
    if x.device.type == "cuda":
        out = ea.fused_aggregate_combine(adjacency, x, w, block_n=block_n,
                                         block_k=block_k)
        _launched("edge_aggregate")
        return out
    ea.fused_launch_tensors(adjacency, x, w, block_n=block_n, block_k=block_k)
    return ea.fused_aggregate_combine_plain(adjacency, x, w)


def gnn_aggregate(adjacency: torch.Tensor, x: torch.Tensor, *,
                  block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """Unfused pass 1: Y_agg = A @ X, materialised in memory (K2 on CUDA)."""
    if x.device.type == "cuda":
        out = eu.aggregate_pass(adjacency, x, block_n=block_n,
                                block_k=block_k)
        _launched("edge_aggregate_unfused.aggregate")
        return out
    eu.aggregate_launch_tensors(adjacency, x, block_n=block_n,
                                block_k=block_k)
    return eu.aggregate_pass_plain(adjacency, x)


def gnn_combine(y_agg: torch.Tensor, w: torch.Tensor, *,
                block_n: int = 256) -> torch.Tensor:
    """Unfused pass 2: Y = Y_agg @ W, reading the spill back (K3 on CUDA)."""
    if y_agg.device.type == "cuda":
        out = eu.combine_pass(y_agg, w, block_n=block_n)
        _launched("edge_aggregate_unfused.combine")
        return out
    eu.combine_launch_tensors(y_agg, w, block_n=block_n)
    return eu.combine_pass_plain(y_agg, w)


def schedule_counts(u_snd: torch.Tensor, u_rcv: torch.Tensor,
                    u_new_src: torch.Tensor, mult: torch.Tensor, K: int,
                    n_tiles: int, total: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile ``(halo, cut)`` int64 counts of stride K (K4 on CUDA).
    ``total``, an upper bound of ``mult.sum()`` where the caller knows one,
    steers the kernel's route (``segment_reduce.k4_route``).

    An empty pair list returns zeros and launches nothing.
    """
    if u_rcv.device.type == "cuda":
        out = sr.schedule_counts(u_snd, u_rcv, u_new_src, mult, K, n_tiles,
                                 total)
        if u_rcv.shape[0]:
            _launched("segment_reduce.schedule_counts")
        return out
    return sr.schedule_counts_plain(u_snd, u_rcv, u_new_src, mult, K, n_tiles)


def attention_pairs(s: int, *, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """The (query, key) pairs of one head of length ``s`` that the mask
    admits: row i sees min(i + 1, window) keys under the causal mask, the
    keys past i - window without it."""
    if causal:
        w = s if window is None else min(window, s)
        return w * (w + 1) // 2 + (s - w) * w
    if window is None or window >= s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float], block_q: int,
                        block_k: int) -> torch.Tensor:
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, block_q=block_q,
                             block_k=block_k)
    _launched("flash_attention", q.dtype)
    return out


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, causal, window, softcap, block_q, block_k):
    fa.check_attention_operands(q, k, v, window=window, softcap=softcap,
                                block_q=block_q, block_k=block_k)
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=softcap)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, block_q, block_k):
    fa.check_attention_operands(q, k, v, window=window, softcap=softcap,
                                block_q=block_q, block_k=block_k)
    fa.check_head_dim(q.shape[3])
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           *args, out_shape=None, **kwargs) -> int:
    """q·k and p·v, 2·D each, over the pairs the mask admits, per query
    head: the count behind K5's bound."""
    b, s, h, d = q_shape
    return 4 * d * b * h * attention_pairs(s, causal=causal, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = fa.DEFAULT_BLOCK_Q,
                    block_k: int = fa.DEFAULT_BLOCK_K) -> torch.Tensor:
    """Attention in the model layout: q (B, S, H, D); k, v (B, S, Hk, D)
    with Hk | H (GQA: query head h reads kv head h // (H // Hk)).  The op
    ``repro_torch::flash_attention``: K5 on CUDA, its plain version on the
    CPU, shapes alone under a fake mode.  Raises when an input requires
    grad: K5 has no backward."""
    fa.check_attention_operands(q, k, v, window=window, softcap=softcap,
                                block_q=block_q, block_k=block_k)
    return _flash_attention_op(q, k, v, causal, window, softcap, block_q,
                               block_k)


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=(),
                         device_types="cuda")
def _embedding_bag_op(table: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    out = eb.embedding_bag(table, indices)
    _launched("embedding_bag")
    return out


@_embedding_bag_op.register_kernel("cpu")
def _(table, indices):
    return eb.embedding_bag_plain(table, indices)


@_embedding_bag_op.register_fake
def _(table, indices):
    eb.check_bag_operands(table, indices)
    return table.new_empty((indices.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::embedding_bag_out",
                         mutates_args=("out",), device_types="cuda")
def _embedding_bag_out_op(table: torch.Tensor, indices: torch.Tensor,
                          out: torch.Tensor) -> None:
    eb.embedding_bag(table, indices, out=out)
    _launched("embedding_bag")


@_embedding_bag_out_op.register_kernel("cpu")
def _(table, indices, out):
    eb.embedding_bag_plain(table, indices, out=out)


@_embedding_bag_out_op.register_fake
def _(table, indices, out):
    eb.check_bag_operands(table, indices, out)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, D) sums of the rows of a (V, D) table that (B, hot) int32 ids
    pick, in the table's dtype, into ``out`` if given.  The op
    ``repro_torch::embedding_bag`` (``embedding_bag_out`` with ``out``): K6
    on CUDA, its plain version on the CPU, shapes alone under a fake mode.
    Raises when the table requires grad: K6 has no backward."""
    eb.check_bag_operands(table, indices, out)
    if out is None:
        return _embedding_bag_op(table, indices)
    _embedding_bag_out_op(table, indices, out)
    return out


class EmbeddingBagFunction(torch.autograd.Function):
    """K6 with a gradient for its table.  The forward is
    :func:`embedding_bag` (K6 on CUDA tensors, counted; the plain version
    on CPU tensors), run with grad mode off as every ``Function``'s forward
    is, so K6's guard against tables that require grad lets it through.
    The backward is the transposed gather, plain PyTorch on every device:
    a dense ``(V, D)`` table gradient with each bag's output gradient
    ``index_add_``-ed into the rows of its ids, which is what ``jnp.take``'s
    VJP gives the reference.  On CUDA ``index_add_`` adds floats with
    atomics, so repeated ids sum in no fixed order.  The ids get no
    gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor,
                indices: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(indices)
        ctx.table_shape = table.shape
        return embedding_bag(table, indices)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        b, hot = indices.shape
        grad = grad_out.new_zeros(ctx.table_shape)
        grad.index_add_(0, indices.reshape(-1).long(),
                        grad_out[:, None, :].expand(b, hot, -1)
                        .reshape(b * hot, -1))
        return grad, None


def embedding_bag_autograd(table: torch.Tensor,
                           indices: torch.Tensor) -> torch.Tensor:
    """:func:`embedding_bag` that autograd can differentiate with respect
    to ``table`` (:class:`EmbeddingBagFunction`)."""
    return EmbeddingBagFunction.apply(table, indices)
