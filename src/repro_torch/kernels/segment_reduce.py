"""K4: the per-capacity segment reduce of the exact-trace schedule.

A :class:`~repro_torch.core.trace.GraphTrace` factorizes its edge list once
into the unique ``(sender, receiver)`` pairs in sender-major order, a
new-sender mask and the per-pair edge multiplicities.  ``receiver // K`` is
monotone within each sender, so for any tile stride K the deduplicated
``(dst_tile, source)`` pairs are runs delimited by a boundary flag, and a
capacity's halo and cut counts are two histograms over destination tiles:

* halo = the pairs that start a run and whose source lies in another tile;
* cut = the multiplicities of the pairs whose source lies in another tile.

:func:`schedule_counts` computes both on the card in one fused pass
(``csrc/segment_reduce.cu``, which replaces the reference's Pallas
``_hist_kernel``); :func:`schedule_counts_plain` is its plain version on any
device.  Counts are int64 throughout: no 2^24 float32 guard, no int32 wrap.

The host decides two things per launch, here, and the kernel follows:
:func:`div_magic` turns ``x // K`` into a multiply and a shift, and
:func:`k4_route` picks the flush target (a shared-memory histogram for few
tiles, device memory for many) and whether halo and cut share one 64-bit
atomic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .edge_aggregate import require_cuda

__all__ = ["boundary_flags", "schedule_counts", "schedule_counts_plain",
           "check_pairs", "div_magic", "k4_route", "K4Route",
           "HIST_SMEM_BYTES", "PACK_LIMIT"]

#: Shared memory of the kernel's per-CTA histogram, at most.
HIST_SMEM_BYTES = 65536
#: Route bits of the C entry point.
ROUTE_SHARED, ROUTE_PACKED = 1, 2
#: Packed counts: halo above bit PACK_SHIFT, cut below; each field < 2^32.
PACK_SHIFT = 32
PACK_LIMIT = 1 << PACK_SHIFT


def div_magic(K: int, idx_bits: int) -> tuple[int, int]:
    """``(m, s)`` with ``x // K == (x * m) >> s`` for every non-negative id
    of a signed ``idx_bits``-bit index type (``x < 2^(idx_bits - 1)``).

    Granlund and Montgomery's round-up multiplier: with ``N = idx_bits - 1``
    and ``l = ceil(log2 K)``, ``m = ceil(2^(N + l) / K)`` and ``s = N + l``;
    then ``2^s <= m K < 2^s + 2^l``, which makes the quotient exact below
    ``2^N``.  For 32-bit ids ``m <= 2^32``, so ``x * m`` fits 63 bits; for
    64-bit ids ``m < 2^64`` and the kernel takes the high word of the
    128-bit product.
    """
    if idx_bits not in (32, 64):
        raise ValueError(f"idx_bits must be 32 or 64, got {idx_bits}")
    N = idx_bits - 1
    if not 1 <= int(K) < 2 ** N:
        raise ValueError(f"K={K} must lie in [1, 2^{N})")
    K = int(K)
    lg = (K - 1).bit_length()            # ceil(log2 K)
    s = N + lg
    return -(-(1 << s) // K), s


class K4Route(NamedTuple):
    """How one launch flushes its counts (``k4_route``)."""

    shared: bool      # a per-CTA histogram in shared memory
    packed: bool      # halo << pack_shift | cut in one 64-bit word
    pack_shift: int   # 0 when not packed

    @property
    def code(self) -> int:
        return (ROUTE_SHARED if self.shared else 0) | (
            ROUTE_PACKED if self.packed else 0)

    def describe(self) -> str:
        return (f"{'shared-memory histogram' if self.shared else 'global'}, "
                + (f"packed (halo above bit {self.pack_shift})"
                   if self.packed else "unpacked"))


def k4_route(n: int, n_tiles: int, total: int | None) -> K4Route:
    """The flush route of ``n`` pairs into ``n_tiles`` bins.

    Packed (halo in the high 32 bits, cut in the low 32) when the host can
    prove that neither field overflows: a tile's halo is at most ``n`` and
    its cut at most ``total``, an upper bound of the multiplicities' sum, so
    both must be below 2^32.  Otherwise (an unknown ``total``, or the
    2^53-scale multiplicities) halo and cut take an atomic each.  Shared
    when the CTA histogram fits ``HIST_SMEM_BYTES``: 8 bytes a bin packed,
    16 unpacked.
    """
    packed = (total is not None and int(n) < PACK_LIMIT
              and 0 <= int(total) < PACK_LIMIT)
    shared = int(n_tiles) * (8 if packed else 16) <= HIST_SMEM_BYTES
    return K4Route(shared, packed, PACK_SHIFT if packed else 0)


def boundary_flags(new_src: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """True where a new ``(source, dst_tile)`` run starts in the unique
    sender-major pair list (``new_src`` is the new-sender mask; the first
    entry always starts a run)."""
    if tile.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=tile.device)
    head = torch.ones((1,), dtype=torch.bool, device=tile.device)
    return new_src.bool() | torch.cat([head, tile[1:] != tile[:-1]])


def check_pairs(u_snd: torch.Tensor, u_rcv: torch.Tensor,
                u_new_src: torch.Tensor, mult: torch.Tensor, K: int,
                n_tiles: int) -> None:
    """One device, equal-length contiguous 1-D operands; int32 or int64
    indices of one type, a bool or uint8 mask, int64 multiplicities."""
    ops = (u_snd, u_rcv, u_new_src, mult)
    if len({str(v.device) for v in ops}) != 1:
        raise ValueError("operands must share one device; got "
                         f"{[str(v.device) for v in ops]}")
    if any(v.dim() != 1 or v.shape != u_snd.shape or not v.is_contiguous()
           for v in ops):
        raise ValueError("operands must be contiguous 1-D tensors of one "
                         f"length; got {[tuple(v.shape) for v in ops]}")
    if u_snd.dtype != u_rcv.dtype or u_snd.dtype not in (torch.int32,
                                                         torch.int64):
        raise ValueError(f"u_snd/u_rcv must both be int32 or int64, got "
                         f"{u_snd.dtype} and {u_rcv.dtype}")
    if u_new_src.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"u_new_src must be bool or uint8, got "
                         f"{u_new_src.dtype}")
    if mult.dtype != torch.int64:
        raise ValueError(f"mult must be int64, got {mult.dtype}")
    if int(K) < 1 or int(n_tiles) < 1:
        raise ValueError(f"need K >= 1 and n_tiles >= 1, got K={K}, "
                         f"n_tiles={n_tiles}")
    if u_snd.dtype == torch.int32 and int(K) > torch.iinfo(torch.int32).max:
        raise ValueError(f"K={K} does not fit the int32 indices")


def schedule_counts(u_snd: torch.Tensor, u_rcv: torch.Tensor,
                    u_new_src: torch.Tensor, mult: torch.Tensor, K: int,
                    n_tiles: int, total: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card: ``(halo, cut)``, int64 ``(n_tiles,)`` each.

    Every receiver must satisfy ``u_rcv // K < n_tiles`` (the trace's
    geometry guarantees it).  ``total``, if given, must bound ``mult.sum()``
    from above (a trace passes its edge count); it lets small enough counts
    share one atomic (:func:`k4_route`).  Launches on the current stream and
    does not synchronise; an empty pair list launches nothing.
    """
    require_cuda(u_rcv, "schedule_counts")
    check_pairs(u_snd, u_rcv, u_new_src, mult, K, n_tiles)
    out = torch.zeros((2, int(n_tiles)), dtype=torch.int64,
                      device=u_rcv.device)
    n = u_rcv.shape[0]
    if n:
        bits = 8 * u_rcv.element_size()
        m, s = div_magic(K, bits)
        route = k4_route(n, n_tiles, total)
        lib = build.library("segment_reduce")
        with torch.cuda.device(u_rcv.device):
            stream = torch.cuda.current_stream(u_rcv.device).cuda_stream
            build.check(lib.schedule_counts(
                u_snd.data_ptr(), u_rcv.data_ptr(), u_new_src.data_ptr(),
                mult.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), n,
                int(K), m - (1 << 64) if m >= 1 << 63 else m, int(n_tiles),
                bits // 8, s, route.code, route.pack_shift, stream),
                "schedule_counts")
    return out[0], out[1]


def schedule_counts_plain(u_snd: torch.Tensor, u_rcv: torch.Tensor,
                          u_new_src: torch.Tensor, mult: torch.Tensor, K: int,
                          n_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: the same steps with PyTorch ops on int64."""
    check_pairs(u_snd, u_rcv, u_new_src, mult, K, n_tiles)
    tile = (u_rcv // int(K)).long()
    remote = (u_snd // int(K)).long() != tile
    new_pair = boundary_flags(u_new_src, tile)
    zeros = torch.zeros(int(n_tiles), dtype=torch.int64, device=tile.device)
    halo = zeros.clone().index_add_(0, tile, (new_pair & remote).long())
    cut = zeros.index_add_(0, tile, torch.where(remote, mult,
                                                torch.zeros_like(mult)))
    return halo, cut
