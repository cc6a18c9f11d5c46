"""GNN family: GCN, GatedGCN, MeshGraphNet and EquiformerV2 (eSCN), the
reference's ``models/gnn`` in PyTorch.

Each model is an ``nn.Module`` whose ``forward(g)`` returns what the
reference's ``forward(cfg, params, g)`` returns, with a ``loss_fn(model,
g)`` beside it.  Message passing is gathers, ``index_add_`` and
``scatter_reduce_`` (:mod:`.layers`): the reference's models reach no
Pallas kernel, so these run none either.  Weights come from the reference's
parameter layout through :mod:`repro_torch.params`.  They train through
``params.tree_loss`` and ``optimizers.make_step`` (``repro_torch.launch.
train`` on a full graph, ``repro_torch.launch.steps.gnn_train_cell`` on a
sampled subgraph), on one device: training sharded over nodes and edges
is not ported.
"""

from . import equiformer_v2, gatedgcn, gcn, meshgraphnet
from .graph import GraphBatch

__all__ = ["gcn", "gatedgcn", "meshgraphnet", "equiformer_v2", "GraphBatch"]
