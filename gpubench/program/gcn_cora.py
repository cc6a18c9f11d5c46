"""GCN's batches in the program's layout."""

from __future__ import annotations


def full_batch(graph: dict, cell):
    """The whole graph as the program's ``GraphBatch``: every node in the
    loss, the edge list as the benchmark drew it (self-loops included)."""
    from repro_torch.models.gnn import GraphBatch

    return GraphBatch(node_feat=graph["x"], senders=graph["senders"],
                      receivers=graph["receivers"], labels=graph["labels"])
