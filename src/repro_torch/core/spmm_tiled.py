"""``spmm_tiled_cta``: the fused block-dense SpMM as the H100 kernel runs it.

The port spec of kernel K1 (:mod:`repro_torch.kernels.edge_aggregate`).  It
keeps every movement form of the reference ``spmm_tiled`` spec unchanged
except the three that the GPU schedule changes.  The reference encodes the
TPU's sequential grid, which keeps a block resident while consecutive grid
steps revisit it; on the H100 each CTA loads the blocks it touches and
nothing carries over between CTAs:

* ``loadweights``: W is loaded once per CTA, ``nbn * N * T * sigma`` (the
  TPU loads it once in total);
* ``loadvertblocks``: X block j is loaded by every CTA,
  ``nbn * nbk * Bk * N * sigma``, also when ``nbk == 1`` (the TPU keeps it
  resident then);
* ``loadadjblocks``: each CTA re-reads its adjacency row-block once per
  feature chunk of ``FC = ACC_ELEMS / Bn`` columns, so the reference form
  is multiplied by ``nfc = ceil(N / FC)``.

On the H100 every ``L2-L1`` level is the traffic from device memory (through
the L2 cache) into a CTA's shared memory — the paper's L2-L1 level.
"""

from __future__ import annotations

import numpy as np

from ..kernels.edge_aggregate import ACC_ELEMS
from .dataflow import DataflowSpec, MovementSpec
from .notation import GraphTileParams, TiledSpMMHardwareParams
from .terms import ceil

__all__ = ["SPMM_TILED_CTA_SPEC", "feature_chunks"]


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _blocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    _, _, K, _, _ = g.astuple_f64()
    nbn = ceil(K / _f64(hw.Bn))
    nbk = ceil(K / _f64(hw.Bk))
    return nbn, nbk


def feature_chunks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Feature chunks per CTA: ``ceil(N / (ACC_ELEMS / Bn))``."""
    N, _, _, _, _ = g.astuple_f64()
    return ceil(N / (_f64(ACC_ELEMS) / _f64(hw.Bn)))


def loadadjblocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Every (Bn x Bk) dense adjacency block, once per feature chunk."""
    s_adj, B = _f64(hw.sigma_adj), _f64(hw.B)
    Bn, Bk = _f64(hw.Bn), _f64(hw.Bk)
    nbn, nbk = _blocks(g, hw)
    nfc = feature_chunks(g, hw)
    block_bits = Bn * Bk * s_adj
    iters = nfc * nbn * nbk * ceil(block_bits / B)
    bits = nfc * nbn * nbk * block_bits
    return bits, iters


def loadvertblocks(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Every CTA loads every (Bk x N) feature block, chunk by chunk."""
    N, _, _, _, _ = g.astuple_f64()
    s, B, Bk = _f64(hw.sigma), _f64(hw.B), _f64(hw.Bk)
    nbn, nbk = _blocks(g, hw)
    n_fetch = nbn * nbk
    block_bits = Bk * N * s
    iters = n_fetch * ceil(block_bits / B)
    bits = n_fetch * block_bits
    return bits, iters


def loadweights(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Each CTA loads the whole (N x T) combine weight once."""
    N, T, _, _, _ = g.astuple_f64()
    s, B = _f64(hw.sigma), _f64(hw.B)
    nbn, _ = _blocks(g, hw)
    iters = nbn * ceil(N * T * s / B)
    bits = nbn * N * T * s
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


def _runnable_analogue():
    from .conformance import FusedCtaAnalogue
    return FusedCtaAnalogue()


SPMM_TILED_CTA_SPEC = DataflowSpec(
    name="spmm_tiled_cta",
    movements=(
        MovementSpec("loadadjblocks", "L2-L1", loadadjblocks, role="edges"),
        MovementSpec("loadvertblocks", "L2-L1", loadvertblocks, role="vertex_in"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
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
