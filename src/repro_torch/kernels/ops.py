"""Public wrappers of the port's kernels (GNN layer K1-K3, trace K4,
attention K5, embedding bag K6).

A CUDA tensor launches the hand-written kernel (or the kernel module
raises); a CPU tensor takes the kernel's plain version.  Nothing falls back
from the card to the CPU.

``LAUNCHES`` counts, per kernel, the launches these wrappers made: each
wrapper adds one right after its kernel launched, and nowhere else, so a run
can show that its main path went through the kernels.

The aggregate and combine passes stay two launches, never joined under a
CUDA graph or ``torch.compile``: the pair is the HyGCN inter-phase analogue,
and one program would remove exactly the traffic it models.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import edge_aggregate as ea
from . import edge_aggregate_unfused as eu
from . import embedding_bag as eb
from . import flash_attention as fa
from . import segment_reduce as sr

__all__ = ["LAUNCHES", "reset_launches", "gnn_aggregate_combine",
           "gnn_aggregate", "gnn_combine", "schedule_counts",
           "flash_attention", "embedding_bag"]

LAUNCHES = {"edge_aggregate": 0, "edge_aggregate_unfused.aggregate": 0,
            "edge_aggregate_unfused.combine": 0,
            "segment_reduce.schedule_counts": 0, "flash_attention": 0,
            "embedding_bag": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gnn_aggregate_combine(adjacency: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, *, block_n: int = 256,
                          block_k: int = 256) -> torch.Tensor:
    """Fused Y = (A @ X) @ W (kernel K1 on CUDA)."""
    if x.device.type == "cuda":
        out = ea.fused_aggregate_combine(adjacency, x, w, block_n=block_n,
                                         block_k=block_k)
        LAUNCHES["edge_aggregate"] += 1
        return out
    ea.fused_launch_tensors(adjacency, x, w, block_n=block_n, block_k=block_k)
    return ea.fused_aggregate_combine_plain(adjacency, x, w)


def gnn_aggregate(adjacency: torch.Tensor, x: torch.Tensor, *,
                  block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """Unfused pass 1: Y_agg = A @ X, materialised in memory (K2 on CUDA)."""
    if x.device.type == "cuda":
        out = eu.aggregate_pass(adjacency, x, block_n=block_n,
                                block_k=block_k)
        LAUNCHES["edge_aggregate_unfused.aggregate"] += 1
        return out
    eu.aggregate_launch_tensors(adjacency, x, block_n=block_n,
                                block_k=block_k)
    return eu.aggregate_pass_plain(adjacency, x)


def gnn_combine(y_agg: torch.Tensor, w: torch.Tensor, *,
                block_n: int = 256) -> torch.Tensor:
    """Unfused pass 2: Y = Y_agg @ W, reading the spill back (K3 on CUDA)."""
    if y_agg.device.type == "cuda":
        out = eu.combine_pass(y_agg, w, block_n=block_n)
        LAUNCHES["edge_aggregate_unfused.combine"] += 1
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
            LAUNCHES["segment_reduce.schedule_counts"] += 1
        return out
    return sr.schedule_counts_plain(u_snd, u_rcv, u_new_src, mult, K, n_tiles)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = fa.DEFAULT_BLOCK_Q,
                    block_k: int = fa.DEFAULT_BLOCK_K) -> torch.Tensor:
    """Attention in the model layout: q (B, S, H, D); k, v (B, S, Hk, D)
    with Hk | H (GQA: query head h reads kv head h // (H // Hk)).  K5 on
    CUDA.  Raises when an input requires grad: K5 has no backward."""
    if q.device.type == "cuda":
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, block_q=block_q,
                                 block_k=block_k)
        LAUNCHES["flash_attention"] += 1
        return out
    fa.check_attention_operands(q, k, v, window=window, softcap=softcap,
                                block_q=block_q, block_k=block_k)
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=softcap)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, D) sums of the rows of a (V, D) table that (B, hot) int32 ids
    pick, in the table's dtype, into ``out`` if given (K6 on CUDA).  Raises
    when the table requires grad: K6 has no backward."""
    if table.device.type == "cuda":
        out = eb.embedding_bag(table, indices, out=out)
        LAUNCHES["embedding_bag"] += 1
        return out
    return eb.embedding_bag_plain(table, indices, out=out)
