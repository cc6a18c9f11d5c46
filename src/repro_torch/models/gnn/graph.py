"""Graph batches: padded, fixed-shape edge lists (the reference's
``models/gnn/graph.py`` as a plain dataclass of tensors).

Graphs are padded to static shapes: masked edges carry zero weight and point
at any node, masked nodes contribute nothing to losses.  Batched small graphs
(the ``molecule`` shape) concatenate their nodes and edges and carry
``graph_ids`` for the per-graph readouts.

A batch may be built from NumPy arrays (the reference's int32 indices among
them); :meth:`GraphBatch.to` makes every field a tensor on one device and
widens the index fields to int64 once, which the gathers, ``index_add_`` and
``scatter_reduce_`` of the layers then take as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Optional

import numpy as np
import torch

from ...backend import resolve_device
from ..common import segment_sum

__all__ = ["GraphBatch", "degrees", "sym_norm_coeffs"]

#: Fields that index nodes or graphs: int64 after :meth:`GraphBatch.to`.
_INDEX_FIELDS = ("senders", "receivers", "graph_ids")


def _tensor(x: Any, dev: torch.device, *, index: bool) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(
        np.require(x, requirements="CW"))
    if index or not t.is_floating_point():
        t = t.long()
    return t.to(dev)


@dataclass
class GraphBatch:
    node_feat: Any                         # (N, F)
    senders: Any                           # (E,)
    receivers: Any                         # (E,)
    edge_feat: Optional[Any] = None        # (E, Fe)
    labels: Optional[Any] = None           # (N,) int or (n_graphs, ...) float
    node_mask: Optional[Any] = None        # (N,) float {0,1}
    edge_mask: Optional[Any] = None        # (E,) float {0,1}
    graph_ids: Optional[Any] = None        # (N,) molecule batching
    positions: Optional[Any] = None        # (N, 3), equivariant models
    wigner: Optional[dict] = None          # {l: (E, m_dim, 2l+1)} eSCN blocks
    n_graphs: int = 1

    def to(self, device=None) -> "GraphBatch":
        """Every field as a tensor on ``device`` (CUDA unless ``"cpu"``):
        index fields and integer labels int64, floats in their own dtype."""
        dev = resolve_device(device)
        kw: dict[str, Any] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None or f.name == "n_graphs":
                continue
            if f.name == "wigner":
                kw[f.name] = {int(l): _tensor(w, dev, index=False)
                              for l, w in v.items()}
            else:
                kw[f.name] = _tensor(v, dev, index=f.name in _INDEX_FIELDS)
        return replace(self, **kw)

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def emask(self) -> torch.Tensor:
        if self.edge_mask is None:
            return torch.ones(self.n_edges, dtype=torch.float32,
                              device=self.senders.device)
        return self.edge_mask

    def nmask(self) -> torch.Tensor:
        if self.node_mask is None:
            return torch.ones(self.n_nodes, dtype=torch.float32,
                              device=self.node_feat.device)
        return self.node_mask


def degrees(g: GraphBatch, *, direction: str = "in") -> torch.Tensor:
    idx = g.receivers if direction == "in" else g.senders
    return segment_sum(g.emask(), idx, g.n_nodes)


def sym_norm_coeffs(g: GraphBatch, *, eps: float = 1e-9) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt(d_i d_j) per edge (self-loops are
    expected to already be present as edges)."""
    deg_in = degrees(g, direction="in")
    deg_out = degrees(g, direction="out")
    inv_i = torch.rsqrt(torch.clamp_min(deg_in, eps))[g.receivers]
    inv_j = torch.rsqrt(torch.clamp_min(deg_out, eps))[g.senders]
    return inv_i * inv_j * g.emask()
