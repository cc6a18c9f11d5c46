// K1: fused GNN aggregate + combine, Y = (A @ X) @ W, for sm_90a.
//
// Replaces: src/repro/kernels/edge_aggregate.py::_kernel, launched by
// fused_aggregate_combine (pl.pallas_call over the grid (N/Bn, N/Bk), which a
// TPU walks in order, carrying a (Bn, F) fp32 VMEM accumulator across the
// source-block axis and applying W on the last source block).
//
// What bounds it on the H100: at GCN-Cora width (N = 2816 padded, F = 1433)
// the block-dense product does 2*N*N*F operations, 600x what the 0.2% dense
// adjacency needs; the port specs pin that schedule.  At three TF32 products
// per product (3xTF32, which holds f32's 1e-5) its floor is 0.139 ms at layer
// 1, beside 0.2-0.3 ms for X's traffic through L2 (all of X once per
// destination block).
//
// What the design does about it (aggregate_hopper.cuh): the product runs on
// the tensor cores (wgmma; 3xTF32 for f32, bf16 as it is), fed by a ring of
// shared-memory stages that TMA fills under mbarriers, and a destination
// block's feature chunks (or, with one chunk, its source blocks) are spread
// over the CTAs of a thread block cluster, so layer 1 runs 528 CTAs and
// layer 2 88.  Each rank folds its (Bn, chunk) aggregate into a
// (Bn, T) partial through the chunk's rows of W,
//   out += (sum_j A[i, j] @ X[j, f0:f1]) @ W[f0:f1, :],
// and the leader sums the partials from distributed shared memory and writes
// the tile once.  The aggregate never reaches device memory: EnGN's on-chip
// inter-phase buffer spans the cluster's SMs.  The combine itself stays fp32
// FMA: it is 1/FC of the product's work.
#include "aggregate_hopper.cuh"

extern "C" int fused_aggregate_combine(const void* a, const void* x, const void* w, void* out,
                                       int n, int f, int t, int bn, int bk, int fc, int dtype,
                                       void* stream) {
  return agg_hopper::dispatch<true>(a, x, w, out, n, f, t, bn, bk, fc, dtype, stream);
}

// Ranks (CTAs) per destination block of the launch above, -1 for a geometry
// it refuses; the wrapper holds it to fused_grid_spec's grid.
extern "C" int fused_ranks(int n, int f, int bn, int bk, int fc) {
  return agg_hopper::ranks(n, f, bn, bk, fc, true);
}

// Clusters of the launch above that fit on the card at once, or minus a
// cudaError_t; chip_smoke.py reports it beside K1's time.
extern "C" int fused_active_clusters(int n, int f, int t, int bn, int bk, int fc, int dtype) {
  return agg_hopper::dispatch_active_clusters<true>(n, f, t, bn, bk, fc, dtype);
}
