"""DLRM (Naumov et al., arXiv:1906.00091), served and trained: the
reference's ``models/dlrm.py`` in PyTorch, with every embedding bag through
kernel K6.

13 dense features go through the bottom MLP 512-256-128; 26 categorical
features each pick rows of their own ``(V, 128)`` table, pooled by K6
(``kernels.ops.embedding_bag``, once per table and forward); the 27 vectors
meet in the pairwise-dot interaction; the top MLP 1024-1024-512-256-1 gives
one logit per sample.  The MLP and interaction products are
``torch.matmul`` in f32, as the reference leaves them to XLA: they stay in
full fp32 only while TF32 is off (PyTorch's default), which the caller
keeps.

Training (:func:`loss_fn`) takes the same forward with each bag through
``ops.embedding_bag_autograd``: K6 forward, and the table gradient by the
transposed gather in plain PyTorch, as the reference's gradient is XLA's
scatter-add.

Not ported here: ``vocab_parallel_embeddings`` and ``param_pspecs`` (the
sharded tables; they come with the distributed substrate) and
``abstract_params``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..backend import resolve_device
from ..kernels import ops
from .common import mlp_apply

__all__ = ["CRITEO_1TB_VOCABS", "DLRMConfig", "DLRM", "embedding_bag",
           "dot_interaction", "serve", "score_candidates", "logits",
           "loss_fn"]

# MLPerf Criteo-1TB per-feature cardinalities (day-0..22 preprocessing,
# capped at 40M rows as in the MLPerf reference implementation).
CRITEO_1TB_VOCABS: tuple[int, ...] = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36)


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_sizes: tuple[int, ...] = CRITEO_1TB_VOCABS
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"
    multi_hot: int = 1            # lookups per sparse feature (bag size)

    def __post_init__(self):
        if len(self.vocab_sizes) != self.n_sparse:
            raise ValueError(f"{len(self.vocab_sizes)} vocab sizes for "
                             f"{self.n_sparse} sparse features")
        if self.bot_mlp[-1] != self.embed_dim:
            raise ValueError(f"bottom MLP ends at {self.bot_mlp[-1]}, not "
                             f"the embed dim {self.embed_dim}")

    def interaction_dim(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        emb = sum(self.vocab_sizes) * self.embed_dim
        bot = sum(a * b + b for a, b in zip((self.n_dense,) + self.bot_mlp[:-1],
                                            self.bot_mlp))
        top_dims = (self.interaction_dim(),) + self.top_mlp
        top = sum(a * b + b for a, b in zip(top_dims[:-1], top_dims[1:]))
        return emb + bot + top


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  weights: Optional[torch.Tensor] = None,
                  combine: str = "sum") -> torch.Tensor:
    """(B, bag) ids -> (B, d) pooled rows.  ``"sum"`` is K6; ``"mean"`` is
    K6's sum over the bag size.  With per-id ``weights`` the bag stays
    plain PyTorch (take, scale, reduce) on every device: K6 has no weights,
    and ``DLRM.forward`` never passes any."""
    if combine not in ("sum", "mean"):
        raise ValueError(combine)
    if weights is not None:
        vecs = table[indices.long()] * weights[..., None]
        return vecs.sum(dim=1) if combine == "sum" else vecs.mean(dim=1)
    pooled = ops.embedding_bag(table, indices)
    return pooled if combine == "sum" else pooled / indices.shape[1]


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """(B, F, d) -> (B, F*(F-1)/2) lower-triangle pairwise dots, in the
    row-major order of ``jnp.tril_indices(F, k=-1)``."""
    f = vectors.shape[1]
    prods = torch.bmm(vectors, vectors.transpose(1, 2))
    iu, ju = torch.tril_indices(f, f, -1, device=vectors.device)
    return prods[:, iu, ju]


def _weight(*shape: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class DLRM(nn.Module):
    """The f32 weights of one config on one device (CUDA by default).

    With a ``generator`` on that device the weights are drawn in place
    there: tables ``normal_(0, 0.02)``, MLP weights He-normal, biases zero.
    So the full-size tables never pass through host memory.  Without one
    they are zeros until :func:`repro_torch.params.load_dlrm` fills them.
    On CUDA the weights must fit the card's free memory, or this raises.
    """

    def __init__(self, cfg: DLRMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if dev.type == "cuda":
            need = 4 * cfg.param_count()
            free, _ = torch.cuda.mem_get_info(dev)
            if need > free:
                raise MemoryError(f"{cfg.name}: {need / 1e9:.2f} GB of f32 "
                                  f"weights, {free / 1e9:.2f} GB free on "
                                  f"{dev}")
        self.cfg = cfg
        bot = (cfg.n_dense,) + cfg.bot_mlp
        top = (cfg.interaction_dim(),) + cfg.top_mlp
        self.tables = nn.ParameterList(_weight(v, cfg.embed_dim, device=dev)
                                       for v in cfg.vocab_sizes)
        for name, dims in (("bot", bot), ("top", top)):
            setattr(self, f"{name}_w", nn.ParameterList(
                _weight(a, b, device=dev) for a, b in zip(dims[:-1], dims[1:])))
            setattr(self, f"{name}_b", nn.ParameterList(
                _weight(b, device=dev) for b in dims[1:]))
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
            if generator is not None:
                for t in self.tables:
                    t.normal_(0.0, 0.02, generator=generator)
                for w in (*self.bot_w, *self.top_w):
                    w.normal_(0.0, math.sqrt(2.0 / w.shape[0]),
                              generator=generator)

    @property
    def device(self) -> torch.device:
        return self.tables[0].device

    def mlp(self, name: str) -> dict:
        """The ``"bot"`` or ``"top"`` MLP as ``{"w": [...], "b": [...]}``."""
        return {"w": list(getattr(self, f"{name}_w")),
                "b": list(getattr(self, f"{name}_b"))}

    def bottom(self, dense: torch.Tensor) -> torch.Tensor:
        """(B, n_dense) -> (B, d): the bottom MLP, ReLU after every layer."""
        return mlp_apply(self.mlp("bot"), dense, final_act=True)

    def top_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, 27, d) features, the bottom output first -> (B,) logits: the
        dot interaction, the bottom output beside it, the top MLP."""
        top_in = torch.cat([feats[:, 0], dot_interaction(feats)], dim=-1)
        return mlp_apply(self.mlp("top"), top_in)[:, 0]

    @torch.inference_mode()
    def forward(self, batch: dict) -> torch.Tensor:
        """batch: dense (B, 13) f32, sparse (B, 26, multi_hot) int32 on the
        model's device -> logits (B,).  K6 writes each table's bags straight
        into its slot of the (B, 27, d) features."""
        dense, sparse = batch["dense"], batch["sparse"]
        cfg = self.cfg
        feats = torch.empty((dense.shape[0], cfg.n_sparse + 1, cfg.embed_dim),
                            dtype=torch.float32, device=dense.device)
        feats[:, 0] = self.bottom(dense)
        for t, table in enumerate(self.tables):
            ops.embedding_bag(table, sparse[:, t, :], out=feats[:, t + 1])
        return self.top_logits(feats)


def logits(model: DLRM, batch: dict) -> torch.Tensor:
    """The forward that autograd can differentiate: batch dense (B, 13) f32,
    sparse (B, 26, multi_hot) int32 -> logits (B,), each bag through
    ``ops.embedding_bag_autograd`` (K6 on the card)."""
    dense, sparse = batch["dense"], batch["sparse"]
    feats = torch.stack([model.bottom(dense)] + [
        ops.embedding_bag_autograd(table, sparse[:, t, :])
        for t, table in enumerate(model.tables)], dim=1)
    return model.top_logits(feats)


def loss_fn(model: DLRM, batch: dict) -> tuple[torch.Tensor, dict]:
    """Binary cross-entropy on the click labels (B,) and accuracy, in f32;
    ``(loss, {"loss", "acc"})``."""
    lg = logits(model, batch)
    labels = batch["labels"].float()
    loss = -torch.mean(labels * F.logsigmoid(lg)
                       + (1 - labels) * F.logsigmoid(-lg))
    acc = torch.mean(((lg > 0) == (labels > 0.5)).float())
    return loss, {"loss": loss, "acc": acc}


def serve(model: DLRM, batch: dict) -> np.ndarray:
    """One request: the numpy ``dense`` and ``sparse`` of ``batch`` copied
    to the model's device, the forward, and the (B,) logits copied back."""
    dev = model.device
    logits = model({"dense": torch.from_numpy(batch["dense"]).to(dev),
                    "sparse": torch.from_numpy(batch["sparse"]).to(dev)})
    return logits.cpu().numpy()


@torch.inference_mode()
def score_candidates(model: DLRM, query: dict,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Retrieval scoring: one query's user vector (the bottom MLP of its
    (1, 13) dense features) dotted against (Nc, d) candidate item
    embeddings, one matrix-vector product -> (Nc,) f32."""
    bot = model.bottom(query["dense"])
    return (candidates @ bot[0]).float()
