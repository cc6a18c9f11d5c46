"""The unfused two-pass block-dense SpMM as a dataflow: the reference's
``spmm_unfused`` and ``spmm_unfused_cta``, the form the H100 kernels K2 + K3
are held to.

``spmm_unfused`` is a copy of the reference's closed form (``repro/core/
spmm_unfused.py``), the HyGCN inter-phase analogue: pass 1 spills the
(K x N) aggregate (``writeinterphase``), pass 2 reads it back
(``readinterphase``) and combines.  Every other level is ``spmm_tiled``'s,
so the fused-minus-unfused delta is exactly the two inter-phase terms.

``spmm_unfused_cta`` is the port spec of kernels K2 + K3
(:mod:`repro_torch.kernels.edge_aggregate_unfused`): the same two
inter-phase terms over the ``spmm_tiled_cta`` forms, W loaded once per CTA
of pass 2.  Both specs name the kernel pair as their runnable target; the
harness holds it to ``spmm_unfused_cta``.
"""

from __future__ import annotations

from .dataflow import DataflowSpec, MovementSpec, SpecModel
from .notation import GraphTileParams, TiledSpMMHardwareParams
from .spmm_tiled import (_blocks, _f64, accumulate, combinefuse,
                         loadadjblocks, loadadjblocks_cta, loadvertblocks,
                         loadvertblocks_cta, loadweights, loadweights_cta,
                         writeout)
from .terms import ceil

__all__ = ["SPMM_UNFUSED_SPEC", "UnfusedSpMMModel", "SPMM_UNFUSED_CTA_SPEC"]


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


def _unfused_spec(name: str, description: str, adj, vert,
                  weights) -> DataflowSpec:
    return DataflowSpec(
        name=name,
        movements=(
            MovementSpec("loadadjblocks", "L2-L1", adj, role="edges"),
            MovementSpec("loadvertblocks", "L2-L1", vert, role="vertex_in"),
            MovementSpec("accumulate", "L1-L1", accumulate, role="compute"),
            MovementSpec("writeinterphase", "L1-L2", writeinterphase,
                         role="interphase"),
            MovementSpec("readinterphase", "L2-L1", readinterphase,
                         role="interphase"),
            MovementSpec("loadweights", "L2-L1", weights, role="weights"),
            # The fused kernel's on-array combine, shared so that the
            # fused-minus-unfused delta stays the two interphase terms.
            MovementSpec("combine", "L1-L1", combinefuse, role="compute"),
            MovementSpec("writeout", "L1-L2", writeout, role="vertex_out"),
        ),
        hw_factory=TiledSpMMHardwareParams,
        description=description,
        runnable=_runnable_analogue,
    )


SPMM_UNFUSED_SPEC = _unfused_spec(
    "spmm_unfused",
    "Unfused two-pass block-dense SpMM (HyGCN inter-phase analogue): the "
    "aggregate round-trips through HBM between separately-compiled "
    "aggregation and combination kernels.",
    loadadjblocks, loadvertblocks, loadweights)

SPMM_UNFUSED_CTA_SPEC = _unfused_spec(
    "spmm_unfused_cta",
    "Unfused two-pass block-dense SpMM as the H100 kernels K2 + K3 run it: "
    "the aggregate round-trips through device memory between two launches.",
    loadadjblocks_cta, loadvertblocks_cta, loadweights_cta)


class UnfusedSpMMModel(SpecModel):
    """Class-API adapter for the unfused two-pass baseline."""

    spec = SPMM_UNFUSED_SPEC
