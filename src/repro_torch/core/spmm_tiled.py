"""The fused block-dense SpMM as a dataflow: the reference's ``spmm_tiled``
and ``spmm_tiled_cta``, the form the H100 kernel K1 is held to.

``spmm_tiled`` is a copy of the reference's closed form (``repro/core/
spmm_tiled.py``): the adjacency of a K-vertex tile is cut into (Bn x Bk)
dense blocks, each block-step does ``acc += A[i,j] @ X[j]``, and the
combine weight is applied straight out of the accumulator, so there is no
inter-phase buffer level.  Its defaults are the reference's (Bn = Bk =
256) and it encodes the TPU's sequential grid, which keeps a block resident
while consecutive grid steps revisit it.

``spmm_tiled_cta`` is the port spec of kernel K1
(:mod:`repro_torch.kernels.edge_aggregate`).  It keeps every movement form
of ``spmm_tiled`` except the three that the GPU schedule changes: on the
H100 each CTA loads the blocks it touches and nothing carries over between
CTAs.

* ``loadweights``: W is loaded once per CTA, ``nbn * N * T * sigma`` (the
  TPU loads it once in total);
* ``loadvertblocks``: X block j is loaded by every CTA,
  ``nbn * nbk * Bk * N * sigma``, also when ``nbk == 1`` (the TPU keeps it
  resident then);
* ``loadadjblocks``: each CTA re-reads its adjacency row-block once per
  feature chunk of ``FC = ACC_ELEMS / Bn`` columns, so the reference form
  is multiplied by ``nfc = ceil(N / FC)``.

On the H100 every ``L2-L1`` level is the traffic from device memory (through
the L2 cache) into a CTA's shared memory — the paper's L2-L1 level.  Both
specs name the kernel analogue K1 as their runnable target; the harness
holds it to ``spmm_tiled_cta``.
"""

from __future__ import annotations

import numpy as np

from ..kernels.edge_aggregate import ACC_ELEMS, DEFAULT_BLOCK_K, DEFAULT_BLOCK_N
from .dataflow import DataflowSpec, MovementSpec, SpecModel
from .notation import GraphTileParams, TiledSpMMHardwareParams
from .terms import ceil

__all__ = ["SPMM_TILED_SPEC", "TiledSpMMModel", "SPMM_TILED_CTA_SPEC", "feature_chunks",
           "kernel_matched_hw"]


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _blocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    _, _, K, _, _ = g.astuple_f64()
    nbn = ceil(K / _f64(hw.Bn))
    nbk = ceil(K / _f64(hw.Bk))
    return nbn, nbk


def loadadjblocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Stream every (Bn x Bk) dense adjacency block once (zeros included)."""
    s_adj, B = _f64(hw.sigma_adj), _f64(hw.B)
    Bn, Bk = _f64(hw.Bn), _f64(hw.Bk)
    nbn, nbk = _blocks(g, hw)
    block_bits = Bn * Bk * s_adj
    iters = nbn * nbk * ceil(block_bits / B)
    bits = nbn * nbk * block_bits
    return bits, iters


def loadvertblocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Stream a (Bk x N) feature block whenever its block index changes:
    ``nbn * nbk`` fetches, except in the single-source-block schedule
    (nbk == 1), where the TPU fetches X exactly once."""
    N, _, _, _, _ = g.astuple_f64()
    s, B, Bk = _f64(hw.sigma), _f64(hw.B), _f64(hw.Bk)
    nbn, nbk = _blocks(g, hw)
    n_fetch = np.where(nbk > 1.0, nbn * nbk, 1.0)
    block_bits = Bk * N * s
    iters = n_fetch * ceil(block_bits / B)
    bits = n_fetch * block_bits
    return bits, iters


def loadweights(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Load the (N x T) combine weight once: it stays resident over the
    whole TPU grid."""
    N, T, _, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    iters = ceil(N * T * s / B)
    bits = N * T * s
    return bits, iters


def accumulate(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """VMEM accumulator read+write per block-step (the MXU aggregation)."""
    N, _, _, _, _ = g.astuple_f64()
    s, Bn = _f64(hw.sigma), _f64(hw.Bn)
    nbn, nbk = _blocks(g, hw)
    bits = 2.0 * nbn * nbk * Bn * N * s
    return bits, nbn * nbk


def combinefuse(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Fused combine: one accumulator read + output-tile write per dst block."""
    N, T, _, _, _ = g.astuple_f64()
    s, Bn = _f64(hw.sigma), _f64(hw.Bn)
    nbn, _ = _blocks(g, hw)
    bits = nbn * Bn * (N + T) * s
    return bits, nbn


def writeout(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Write the padded (ceil(K/Bn)*Bn x T) output tiles back to L2."""
    _, T, _, _, _ = g.astuple_f64()
    s, B, Bn = _f64(hw.sigma), _f64(hw.B), _f64(hw.Bn)
    nbn, _ = _blocks(g, hw)
    tile_bits = Bn * T * s
    iters = nbn * ceil(tile_bits / B)
    bits = nbn * tile_bits
    return bits, iters


def feature_chunks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Feature chunks per CTA: ``ceil(N / (ACC_ELEMS / Bn))``."""
    N, _, _, _, _ = g.astuple_f64()
    return ceil(N / (_f64(ACC_ELEMS) / _f64(hw.Bn)))


def loadadjblocks_cta(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Every (Bn x Bk) dense adjacency block, once per feature chunk."""
    bits, iters = loadadjblocks(g, hw)
    nfc = feature_chunks(g, hw)
    return nfc * bits, nfc * iters


def loadvertblocks_cta(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Every CTA loads every (Bk x N) feature block, chunk by chunk."""
    N, _, _, _, _ = g.astuple_f64()
    s, B, Bk = _f64(hw.sigma), _f64(hw.B), _f64(hw.Bk)
    nbn, nbk = _blocks(g, hw)
    n_fetch = nbn * nbk
    block_bits = Bk * N * s
    iters = n_fetch * ceil(block_bits / B)
    bits = n_fetch * block_bits
    return bits, iters


def loadweights_cta(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Each CTA loads the whole (N x T) combine weight once."""
    bits, iters = loadweights(g, hw)
    nbn, _ = _blocks(g, hw)
    return nbn * bits, nbn * iters


def _runnable_analogue():
    from .conformance import FusedCtaAnalogue
    return FusedCtaAnalogue()


SPMM_TILED_SPEC = DataflowSpec(
    name="spmm_tiled",
    movements=(
        MovementSpec("loadadjblocks", "L2-L1", loadadjblocks, role="edges"),
        MovementSpec("loadvertblocks", "L2-L1", loadvertblocks, role="vertex_in"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
        MovementSpec("accumulate", "L1-L1", accumulate, role="compute"),
        MovementSpec("combinefuse", "L1-L1", combinefuse, role="compute"),
        MovementSpec("writeout", "L1-L2", writeout, role="vertex_out"),
    ),
    hw_factory=TiledSpMMHardwareParams,
    description="Generic fused block-dense SpMM (the repo's Pallas-kernel "
                "analogue): no inter-phase buffer, dense topology blocks.",
    runnable=_runnable_analogue,
)

SPMM_TILED_CTA_SPEC = DataflowSpec(
    name="spmm_tiled_cta",
    movements=(
        MovementSpec("loadadjblocks", "L2-L1", loadadjblocks_cta, role="edges"),
        MovementSpec("loadvertblocks", "L2-L1", loadvertblocks_cta,
                     role="vertex_in"),
        MovementSpec("loadweights", "L2-L1", loadweights_cta, role="weights"),
        MovementSpec("accumulate", "L1-L1", accumulate, role="compute"),
        MovementSpec("combinefuse", "L1-L1", combinefuse, role="compute"),
        MovementSpec("writeout", "L1-L2", writeout, role="vertex_out"),
    ),
    hw_factory=TiledSpMMHardwareParams,
    description="Fused block-dense SpMM as the H100 kernel K1 runs it: one "
                "CTA per destination block, feature chunks, no inter-phase "
                "buffer.",
    runnable=_runnable_analogue,
)


def kernel_matched_hw(**overrides) -> TiledSpMMHardwareParams:
    """Hardware params with Bn/Bk taken from the kernel module K1 runs
    (``kernels.edge_aggregate.DEFAULT_BLOCK_{N,K}``); ``overrides`` win."""
    overrides.setdefault("Bn", DEFAULT_BLOCK_N)
    overrides.setdefault("Bk", DEFAULT_BLOCK_K)
    return TiledSpMMHardwareParams(**overrides)


class TiledSpMMModel(SpecModel):
    """Class-API adapter for the tiled-SpMM baseline."""

    spec = SPMM_TILED_SPEC
