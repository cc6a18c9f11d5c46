"""Communication byte models: the wire bytes a rank receives per step
under each parallel strategy.

A copy of the reference's collective primitives and per-strategy models
(``core/tpu_model.py``): plain float64 arithmetic, held bit for bit to the
reference by ``tests/test_torch_distributed.py``.  On a ring the
"iterations" are the n - 1 hops and the per-hop payload is the shard, so
data movement is shard * (n - 1), as EnGN's ring-edge-reduce moves
M * (M - 1) * T elements around its PE ring.  The measured side is
:class:`repro_torch.distributed.comm.CollectiveLedger`, which
:func:`repro_torch.core.validation.validate_traffic` compares with these.

The TPU machine model beside them in the reference (``TPUHardware``,
``roofline``, ``mxu_padding_waste``) is not copied: the port's machine
model is the H100's.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["allgather_bytes", "reduce_scatter_bytes", "allreduce_bytes",
           "all_to_all_bytes", "collective_permute_bytes", "CommTerm",
           "CommModel", "dp_gradient_sync", "tp_activation_sync",
           "moe_dispatch_sync", "spmm_feature_allgather",
           "ring_spmm_traffic", "dlrm_embedding_exchange"]


def allgather_bytes(global_bytes: float, n: int) -> float:
    """Ring all-gather of a tensor of ``global_bytes``: recv (n-1)/n of it."""
    return global_bytes * (n - 1) / n if n > 1 else 0.0


def reduce_scatter_bytes(global_bytes: float, n: int) -> float:
    return global_bytes * (n - 1) / n if n > 1 else 0.0


def allreduce_bytes(global_bytes: float, n: int) -> float:
    """Ring all-reduce = reduce-scatter + all-gather."""
    return 2.0 * global_bytes * (n - 1) / n if n > 1 else 0.0


def all_to_all_bytes(per_chip_bytes: float, n: int) -> float:
    """Each rank re-distributes its shard: keeps 1/n, exchanges the rest."""
    return per_chip_bytes * (n - 1) / n if n > 1 else 0.0


def collective_permute_bytes(per_chip_bytes: float) -> float:
    return per_chip_bytes


@dataclass(frozen=True)
class CommTerm:
    """One analytical communication term (a movement level of the wire)."""

    name: str
    fabric: str                  # "ici" | "dcn" | "hbm"
    bytes_per_chip: float
    description: str = ""


@dataclass(frozen=True)
class CommModel:
    """A list of CommTerms = the communication model of one strategy."""

    strategy: str
    terms: tuple[CommTerm, ...]

    def total(self, fabric: str | None = None) -> float:
        return sum(t.bytes_per_chip for t in self.terms
                   if fabric is None or t.fabric == fabric)

    def __getitem__(self, name: str) -> CommTerm:
        for t in self.terms:
            if t.name == name:
                return t
        raise KeyError(name)


def dp_gradient_sync(param_bytes: float, dp: int, *,
                     compressed_ratio: float = 1.0) -> CommModel:
    """Data-parallel gradient all-reduce over ``dp`` ranks per step.

    ``compressed_ratio`` < 1 models int8 error-feedback compression
    (``repro_torch.optim.compression``): wire bytes scale with the
    compressed width.
    """
    return CommModel("dp", (
        CommTerm("grad_allreduce", "ici",
                 allreduce_bytes(param_bytes * compressed_ratio, dp),
                 f"ring all-reduce of {param_bytes:.3g}B grads over dp={dp}"),
    ))


def tp_activation_sync(act_bytes_per_layer: float, layers: int, tp: int,
                       *, seq_sharded: bool = True) -> CommModel:
    """Megatron-style tensor parallelism: per layer, one all-gather into each
    of the two blocks (attn, mlp) and one reduce-scatter out of each when
    activations are sequence-sharded; plain all-reduce otherwise."""
    if seq_sharded:
        per_layer = 2 * (allgather_bytes(act_bytes_per_layer, tp)
                         + reduce_scatter_bytes(act_bytes_per_layer, tp))
        desc = "AG+RS x2 blocks/layer (sequence-sharded residual)"
    else:
        per_layer = 2 * allreduce_bytes(act_bytes_per_layer, tp)
        desc = "all-reduce x2 blocks/layer"
    return CommModel("tp", (
        CommTerm("tp_collectives", "ici", per_layer * layers, desc),
    ))


def moe_dispatch_sync(tokens_per_chip: int, d_model: int, top_k: int,
                      ep: int, layers: int, *,
                      dtype_bytes: int = 2) -> CommModel:
    """Expert-parallel all-to-all: dispatch + return, per MoE layer."""
    payload = tokens_per_chip * top_k * d_model * dtype_bytes
    per_layer = 2 * all_to_all_bytes(payload, ep)
    return CommModel("ep", (
        CommTerm("moe_all_to_all", "ici", per_layer * layers,
                 f"dispatch+combine a2a of {payload:.3g}B x {layers} layers"),
    ))


def spmm_feature_allgather(n_nodes: int, d_feat: int, n: int,
                           *, dtype_bytes: int = 4,
                           layers: int = 1) -> CommModel:
    """Baseline 1D-partitioned SpMM (paper-faithful "stream all vertices"):
    every rank all-gathers the full feature matrix each layer, the
    multi-device analogue of EnGN's loadvertL2 with no degree cache."""
    global_bytes = n_nodes * d_feat * dtype_bytes
    return CommModel("spmm_1d", (
        CommTerm("feature_allgather", "ici",
                 allgather_bytes(global_bytes, n) * layers,
                 f"all-gather {global_bytes:.3g}B node features x {layers} "
                 "layers"),
    ))


def ring_spmm_traffic(n_nodes: int, d_feat: int, n: int,
                      *, dtype_bytes: int = 4, layers: int = 1) -> CommModel:
    """RER-adapted ring SpMM: feature shards circulate the ring, each hop
    overlapped with the local segment-sum of the resident shard.

    Total wire volume equals the all-gather (the ring moves the same bytes,
    EnGN's Fig. 3 lesson that RER movement is large but cheap because it
    stays on the fast fabric), but no rank ever materializes the full
    feature matrix, and each hop can overlap with compute.
    """
    global_bytes = n_nodes * d_feat * dtype_bytes
    return CommModel("spmm_ring", (
        CommTerm("ring_hops", "ici",
                 allgather_bytes(global_bytes, n) * layers,
                 f"{n - 1} ppermute hops of {global_bytes / max(n,1):.3g}B "
                 "shards"),
    ))


def dlrm_embedding_exchange(batch_per_chip: int, n_tables: int,
                            embed_dim: int, n: int, *, dtype_bytes: int = 4,
                            with_backward: bool = True) -> CommModel:
    """Model-parallel embedding tables + data-parallel MLPs: the MLPerf DLRM
    hybrid.  Forward: pooled embeddings all-to-all from table-major to
    batch-major; backward mirrors it with gradients."""
    payload = batch_per_chip * n_tables * embed_dim * dtype_bytes
    factor = 2 if with_backward else 1
    return CommModel("dlrm_hybrid", (
        CommTerm("embedding_all_to_all", "ici",
                 factor * all_to_all_bytes(payload, n),
                 f"a2a of {payload:.3g}B pooled embeddings "
                 f"(fwd{'+bwd' if with_backward else ''})"),
    ))
