"""Seeded Cora-sized inputs for the GNN layer kernels (the trace datasets'
graph generators are in :mod:`repro_torch.data.synthetic`).

The reference's GCN-Cora model (``configs/gcn_cora.py``) runs on the Cora
citation graph: 2708 vertices, 10556 directed edges (5278 undirected
links), 1433-wide binary bag-of-words features.  The dataset itself is not
shipped, so :func:`cora_graph` draws a graph of exactly that size from a
seed, adds one self-loop per vertex and weights every edge with GCN's
symmetric normalisation ``1 / sqrt(d_in(i) * d_out(j))``.

The kernels take a block-dense adjacency whose side divides into their
blocks (``n % block == 0``); padding is the caller's job, and
:meth:`Graph.dense_adjacency` pads with zero rows and columns, which leave
the real vertices' results unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CORA_V", "CORA_E", "CORA_WIDTHS", "CORA_FEATURE_DENSITY",
           "PAD_MULTIPLE", "padded_size", "Graph", "sym_norm_coeffs",
           "cora_graph", "cora_features"]

#: Cora citation-graph size (the reference keeps the same two constants).
CORA_V = 2708
CORA_E = 10556
#: GCN-Cora per-layer widths: 1433 input features, 16 hidden, 7 classes.
CORA_WIDTHS = (1433, 16, 7)
#: Share of nonzero bag-of-words entries (about 18 words per paper).
CORA_FEATURE_DENSITY = 0.0127
#: Graphs are padded to a multiple of this many vertices (2708 -> 2816).
PAD_MULTIPLE = 128


def padded_size(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return -(-n // multiple) * multiple


def sym_norm_coeffs(senders: np.ndarray, receivers: np.ndarray,
                    n_nodes: int, *, eps: float = 1e-9) -> np.ndarray:
    """GCN symmetric normalisation per edge, in float32: self-loops are
    expected to be present as edges already."""
    deg_in = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    deg_out = np.bincount(senders, minlength=n_nodes).astype(np.float32)
    inv_i = 1.0 / np.sqrt(np.maximum(deg_in, np.float32(eps)))
    inv_j = 1.0 / np.sqrt(np.maximum(deg_out, np.float32(eps)))
    return (inv_i[receivers] * inv_j[senders]).astype(np.float32)


@dataclass(frozen=True)
class Graph:
    """An edge list with one weight per edge (self-loops included)."""

    n_nodes: int
    senders: np.ndarray     # (E,) int64
    receivers: np.ndarray   # (E,) int64
    weights: np.ndarray     # (E,) float32

    def dense_adjacency(self, n_pad: int | None = None) -> np.ndarray:
        """``A[receiver, sender] = weight``, zero-padded to ``n_pad``."""
        n_pad = padded_size(self.n_nodes) if n_pad is None else n_pad
        if n_pad < self.n_nodes:
            raise ValueError(f"n_pad={n_pad} < n_nodes={self.n_nodes}")
        a = np.zeros((n_pad, n_pad), np.float32)
        np.add.at(a, (self.receivers, self.senders), self.weights)
        return a


def cora_graph(seed: int = 0, *, n_nodes: int = CORA_V,
               n_edges: int = CORA_E) -> Graph:
    """A seeded undirected graph with Cora's vertex and edge counts:
    ``n_edges / 2`` distinct links, both directions, no self-links, then a
    self-loop per vertex, symmetric-normalised."""
    if n_edges % 2:
        raise ValueError(f"n_edges={n_edges} must be even (undirected links)")
    rng = np.random.default_rng(seed)
    n_links = n_edges // 2
    links = np.empty((0, 2), np.int64)
    while len(links) < n_links:
        pairs = rng.integers(0, n_nodes, (2 * n_links, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        links = np.unique(np.concatenate([links, np.sort(pairs, axis=1)]),
                          axis=0)
    links = links[rng.choice(len(links), n_links, replace=False)]
    loops = np.arange(n_nodes, dtype=np.int64)
    senders = np.concatenate([links[:, 0], links[:, 1], loops])
    receivers = np.concatenate([links[:, 1], links[:, 0], loops])
    return Graph(n_nodes=n_nodes, senders=senders, receivers=receivers,
                 weights=sym_norm_coeffs(senders, receivers, n_nodes))


def cora_features(seed: int = 0, *, n_nodes: int = CORA_V,
                  n_pad: int | None = None,
                  width: int = CORA_WIDTHS[0]) -> np.ndarray:
    """Binary bag-of-words features, zero rows for padding vertices."""
    n_pad = padded_size(n_nodes) if n_pad is None else n_pad
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, width), np.float32)
    x[:n_nodes] = rng.random((n_nodes, width)) < CORA_FEATURE_DENSITY
    return x
