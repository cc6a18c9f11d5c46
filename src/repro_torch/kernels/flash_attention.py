"""K5: causal online-softmax (flash) attention.

The reference's Pallas kernel walks a grid ``(B*H, S/BQ, S/BK)`` on a TPU
with the kv axis innermost and in order, carrying the running max, sum and
``(BQ, D)`` accumulator in VMEM scratch across it, so the ``(BQ, BK)`` score
tile never leaves the chip.  On the H100 one CTA owns a block of query rows
of one (batch, head) and walks the kv tiles itself; kv tiles wholly above
the diagonal or outside the window are skipped.  bf16 inputs (the serving
path's) take ``csrc/flash_attention_hopper.cuh``: 192 query rows per CTA
at D = 64 and 128 above, both products on the tensor cores (``wgmma``, p
split into two bf16 terms for p·v), K and V tiles by TMA into a two-stage
ring.  f32 inputs take ``csrc/flash_attention_tf32.cuh``: both products on
the tensor cores as 3xTF32 ``wgmma`` (each operand split into TF32 hi and
lo terms), q and K by TMA, V transposed K-major in shared memory by the
producer warps; 192 query rows per CTA up to D = 64, 128 at D = 128 and 64
above.  The CUDA sources alone decide that geometry (grid, kv tile, tiles
walked, shared memory); this module passes them only the shapes.

The TPU kernel's ``block_q`` and ``block_k`` are sized for VMEM.  A CTA's
tile here is bounded by registers and 227 KB of shared memory instead, so the
kernel keeps its own tile and takes the block sizes only as the reference's
shape contract: blocks are ``min(block, s)`` and ``s`` must divide into them,
so a call the TPU kernel refuses is refused here too.

Layouts are the model's: ``q`` ``(B, S, H, D)``, ``k`` and ``v``
``(B, S, Hk, D)`` with ``Hk | H``; query head ``h`` reads kv head
``h // (H // Hk)``, the order ``jnp.repeat(k, H // Hk, axis=2)`` gives.

:func:`flash_attention` launches the kernel on CUDA tensors and raises for
any other; :func:`flash_attention_plain` is the plain version that the CPU
path and the card-side comparison use.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .edge_aggregate import DTYPE_CODES, require_cuda
from .ref import flash_attention_ref

__all__ = ["DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K", "check_head_dim",
           "check_attention_operands", "flash_attention",
           "flash_attention_plain"]

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def check_head_dim(d: int) -> None:
    """The CUDA kernels' limit on the head dim: the bf16 kernel takes 16
    columns of q·k per ``wgmma`` step and the f32 kernel's V transpose
    moves 16 columns at a time, so D is a multiple of 16, up to 256
    (gemma2's head)."""
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d}: the CUDA kernel takes multiples of "
                         "16 in [16, 256]")


def check_attention_operands(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: Optional[int],
                             softcap: Optional[float], block_q: int,
                             block_k: int) -> None:
    """Shapes, dtypes, devices, the reference's block contract, and no
    input that autograd would need a gradient of (the TPU kernel has no
    backward).  The kernel's own limit on
    the head dim is :func:`check_head_dim`'s."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward (the TPU kernel "
                         "has none); call it under torch.inference_mode()")
    if len({(t.dtype, str(t.device)) for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v must share one dtype and device; got "
                         f"{[(t.dtype, str(t.device)) for t in (q, k, v)]}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported; expected one of "
                         f"{list(DTYPE_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, S, Hk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or h % hk:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} with Hk | H")
    bq, bk = min(block_q, s), min(block_k, s)
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"s={s} must divide into block_q={bq} and "
                         f"block_k={bk} blocks (the reference's contract)")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be None or >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap={softcap} must be None or > 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """K5 on the card: attention of ``q`` over ``k``, ``v`` with fp32 sums,
    output in ``q.dtype``, shape ``(B, S, H, D)``.  Operands are made
    contiguous and 16-byte aligned (the kernels' tensor maps and the f32
    kernel's 16-byte V loads need it).

    Launches on the current stream and does not synchronise.
    """
    require_cuda(q, "flash_attention")
    check_attention_operands(q, k, v, window=window, softcap=softcap,
                             block_q=block_q, block_k=block_k)
    b, s, h, d = q.shape
    check_head_dim(d)
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, int(causal), window or 0,
            softcap or 0.0, d ** -0.5, DTYPE_CODES[q.dtype], stream),
            "flash_attention")
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: the fp32 oracle with k and v
    repeated to the query heads (query head h reads kv head h // rep)."""
    rep = q.shape[2] // k.shape[2]
    return flash_attention_ref(q, k.repeat_interleave(rep, dim=2),
                               v.repeat_interleave(rep, dim=2), causal=causal,
                               window=window, softcap=softcap)
