"""GNN family: the configurations of GCN, GatedGCN, MeshGraphNet and
EquiformerV2 (the reference's ``models/gnn``).

Only the config classes are ported, which the architecture registry
(:mod:`repro_torch.configs`) and its workload bridges read.  The models
themselves (message passing, the eSCN convolution, graph batches) are not
ported yet.
"""

from . import equiformer_v2, gatedgcn, gcn, meshgraphnet

__all__ = ["gcn", "gatedgcn", "meshgraphnet", "equiformer_v2"]
