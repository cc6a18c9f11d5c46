"""``spmm_unfused_cta``: the unfused two-pass SpMM as the H100 kernels run it.

The port spec of kernels K2 + K3
(:mod:`repro_torch.kernels.edge_aggregate_unfused`).  Pass 1 spills the
(K x N) aggregate to memory (``writeinterphase``); pass 2 reads it back
(``readinterphase``) over the grid ``(nbn,)``, loading W once per CTA.  All
other levels are the ``spmm_tiled_cta`` forms, so the fused-minus-unfused
delta is exactly the two inter-phase terms, which are copied unchanged from
the reference ``spmm_unfused`` spec.
"""

from __future__ import annotations

from .dataflow import DataflowSpec, MovementSpec
from .notation import GraphTileParams, TiledSpMMHardwareParams
from .spmm_tiled import (_blocks, _f64, accumulate, combinefuse,
                         loadadjblocks, loadvertblocks, loadweights, writeout)
from .terms import ceil

__all__ = ["SPMM_UNFUSED_CTA_SPEC"]


def writeinterphase(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Pass 1 spills the padded (ceil(K/Bn)*Bn x N) aggregate to L2."""
    N, _, _, _, _ = g.astuple_f64()
    s, B, Bn = _f64(hw.sigma), _f64(hw.B), _f64(hw.Bn)
    nbn, _ = _blocks(g, hw)
    tile_bits = Bn * N * s
    iters = nbn * ceil(tile_bits / B)
    bits = nbn * tile_bits
    return bits, iters


def readinterphase(g: GraphTileParams, hw: TiledSpMMHardwareParams):
    """Pass 2 fetches each aggregate tile back — the P_s = K dense-row
    realization of the paper's ``P_s*N*sigma`` read term."""
    return writeinterphase(g, hw)


def _runnable_analogue():
    from .conformance import UnfusedCtaAnalogue
    return UnfusedCtaAnalogue()


SPMM_UNFUSED_CTA_SPEC = DataflowSpec(
    name="spmm_unfused_cta",
    movements=(
        MovementSpec("loadadjblocks", "L2-L1", loadadjblocks, role="edges"),
        MovementSpec("loadvertblocks", "L2-L1", loadvertblocks, role="vertex_in"),
        MovementSpec("accumulate", "L1-L1", accumulate, role="compute"),
        MovementSpec("writeinterphase", "L1-L2", writeinterphase, role="interphase"),
        MovementSpec("readinterphase", "L2-L1", readinterphase, role="interphase"),
        MovementSpec("loadweights", "L2-L1", loadweights, role="weights"),
        MovementSpec("combine", "L1-L1", combinefuse, role="compute"),
        MovementSpec("writeout", "L1-L2", writeout, role="vertex_out"),
    ),
    hw_factory=TiledSpMMHardwareParams,
    description="Unfused two-pass block-dense SpMM as the H100 kernels K2 + "
                "K3 run it: the aggregate round-trips through device memory "
                "between two launches.",
    runnable=_runnable_analogue,
)
