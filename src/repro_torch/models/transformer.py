"""Decoder-only transformer: served (prefill through kernel K5, then
greedy-ready decode steps over a KV cache) and trained (``loss_fn``,
``make_train_step``).

The reference's ``models/transformer.py`` in PyTorch: dense configs
(SmolLM, granite, gemma2's local/global pattern with soft-caps) and MoE
configs with an optional dense residual branch (qwen3-moe, arctic).  Layers
are grouped by the repeating ``window_pattern`` as in the reference: layer
``g * P + i`` is group ``g``'s pattern entry ``i``, and each pattern entry
keeps its own KV cache ``(G, B, S_entry, Hk, d_head)``, where a windowed
entry holds a ring of ``window`` slots and a global one the whole sequence.

Serving runs a :class:`Transformer` module under ``torch.inference_mode()``:
prefill attention is ``kernels.ops.flash_attention`` on every layer (K5 on
CUDA tensors, its plain version on CPU tensors), decode attention plain
PyTorch (:mod:`.attention`).  An MoE layer runs the capacity dispatch
(:func:`.moe.moe_ffn_capacity`) over all ``B * S`` tokens of a prefill or
forward call, as the reference's ``_ffn_block`` does, and the all-expert
path (:func:`.moe.moe_ffn_reference`) in a decode step.

Training differentiates a tree of f32 tensors in the reference's parameter
layout (``{"embed", "final_norm", "blocks": [per pattern entry, (G, ...)
stacks]}``, :mod:`repro_torch.params`), as the reference's ``loss_fn``
does: the blocks are cast to the compute dtype, attention is
:func:`.attention.chunked_causal_attention` (K5 has no backward in either
package, and the reference trains through the same chunked path), each
decoder group is rematerialised under ``cfg.remat``, and a large
vocabulary's cross-entropy is computed and rematerialised a sequence chunk
at a time.

Distribution (``policy=``, a :class:`repro_torch.distributed.sharding.
ShardingPolicy`): each rank runs the serving functions over its own
:class:`ShardedTransformer` (its slices of the weights by
:func:`param_pspecs`, from ``repro_torch.params.shard_transformer``), with
the collectives the reference leaves to GSPMD written out:

* the batch splits over the dp axes, and the residual stream's sequence
  over the ``model`` axis when ``policy.seq_parallel_residual`` (the
  reference's ``act_spec``): an all-gather of the sequence before each
  column-parallel product, a reduce-scatter after each row-parallel one;
  without it the row-parallel products end in an all-reduce;
* attention is tensor-parallel over heads when both head counts divide
  ``tp`` (K5 on the rank's heads in prefill), else context-parallel: the
  queries stay sequence-sharded, keys and values are all-gathered, and the
  chunked path takes ``q_offset`` (neither the TPU kernel nor K5 takes a
  query offset);
* the dense FFN is column- then row-parallel; MoE experts shard over
  ``model`` (:func:`repro_torch.models.moe.moe_ffn_ep`, its balance loss
  averaged over every rank), the arctic residual branch beside them
  column- and row-parallel;
* the embedding and the logits are vocab-parallel where the vocabulary
  divides ``tp``: a masked local lookup summed over the ranks, and each
  rank's vocabulary columns of the logits;
* decode keeps the cache sequence-sharded over ``DecodePolicy.
  cache_seq_axes`` and its batch over ``batch_axes``; each shard attends
  over its slots and the flash-decoding partials combine over the shards.

Training under a policy (:func:`loss_fn` and :func:`make_train_step` with
``policy=``) runs the same layer loop over a tree of this rank's blocks in
the reference's layout, laid out by :func:`train_pspecs` (FSDP over the dp
axes on top of :func:`param_pspecs`, the reference's ``fsdp_specs``):

* each FSDP leaf is all-gathered over dp on use (a block's slice, in the
  compute dtype, inside its rematerialised group, so the backward's
  recompute gathers again; a top-level leaf once a step, in its stored
  dtype), and the gather's backward reduce-scatters its gradient;
* the cross-entropy is vocab-parallel where the vocabulary divides ``tp``
  (each rank's logits columns, the logsumexp from an all-reduce max and an
  all-reduce sum, the gold logit a masked local gather summed over tp),
  on the sequence-chunked path too; a tied embedding takes gradient from
  both its uses;
* after the backward the gradients are made whole: leaves replicated over
  ``tp`` whose inputs are sharded (the sequence-parallel residual's norms,
  the context-parallel path's weights, the router) are summed over tp,
  leaves replicated over dp are averaged with ``comm.all_reduce_grads``,
  FSDP leaves divided by dp; clipping reads the global norm
  (``sharding.sharded_global_norm``), so every rank clips alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..backend import resolve_device
from ..distributed import comm
from ..distributed.sharding import (fsdp_specs, sharded_global_norm,
                                    spec_axes as sharding_axes)
from ..kernels import ops
from ..optim.optimizers import make_step
from ..tree import is_spec, tree_map, tree_paths
from . import attention as attn_lib
from . import moe as moe_lib
from .common import (apply_rope, cross_entropy_loss, rms_norm, rope_freqs,
                     softcap, swiglu)
from .moe import MOE_KEYS, MoE, MoEConfig

__all__ = ["TransformerConfig", "DecoderLayer", "Transformer", "LAYER_KEYS",
           "RESIDUAL_KEYS", "layer_keys", "forward", "forward_hidden",
           "make_prefill_step", "make_serve_step", "cache_shapes",
           "init_cache", "loss_fn", "make_train_step", "param_pspecs",
           "DecodePolicy", "cache_pspecs", "ShardedTransformer",
           "gather_logits", "abstract_params", "abstract_cache",
           "train_pspecs"]

#: Per-layer weights of a dense config, in the reference's block-dict names
#: and (in, out) layout: ``x @ w``.
LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
              "w_down")
#: An MoE layer's dense residual branch (arctic), in place of the FFN.
RESIDUAL_KEYS = ("res_gate", "res_up", "res_down")


@dataclass(frozen=True)
class TransformerConfig:
    """One decoder-only architecture.  ``remat`` and ``q_chunk`` steer
    training only: ``"full"`` rematerialises each decoder group in the
    backward pass (``"dots"`` does the same here: PyTorch's checkpoint has
    no policy that keeps only the products), ``"none"`` keeps every
    activation; ``q_chunk`` is the training attention's query chunk.
    Serving ignores both (K5 takes no chunking)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    # Repeating per-layer window pattern; None entries are global-causal.
    # gemma2: (4096, None).  Its length must divide n_layers.
    window_pattern: tuple[Optional[int], ...] = (None,)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    remat: str = "full"              # "none" | "full" | "dots"
    q_chunk: int = 1024
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.n_layers % len(self.window_pattern):
            raise ValueError(f"{self.name}: window pattern "
                             f"{self.window_pattern} does not divide "
                             f"{self.n_layers} layers")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_kv_heads} kv heads do "
                             f"not divide {self.n_heads} heads")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.window_pattern)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        d, H, Hk, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        attn = d * (H * dh) + 2 * d * (Hk * dh) + (H * dh) * d
        per_layer = attn + 2 * d  # + norms
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
            if m.dense_residual_d_ff:
                per_layer += 3 * d * m.dense_residual_d_ff
        else:
            per_layer += 3 * d * self.d_ff
        total = self.n_layers * per_layer + self.vocab * d + d
        if not self.tie_embeddings:
            total += self.vocab * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        expert_all = 3 * m.n_experts * d * m.d_ff_expert
        expert_act = 3 * m.top_k * d * m.d_ff_expert
        return self.param_count() - self.n_layers * (expert_all - expert_act)


def _weight(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


def layer_keys(cfg: TransformerConfig) -> tuple[str, ...]:
    """A layer's weights other than its experts (``layer.moe``), by their
    reference names."""
    if cfg.moe is None:
        return LAYER_KEYS
    return LAYER_KEYS[:6] + (RESIDUAL_KEYS if cfg.moe.dense_residual_d_ff
                             else ())


class DecoderLayer(nn.Module):
    """One pre-norm block: GQA attention with RoPE, then a SwiGLU FFN, or
    for an MoE config the experts (``moe``) and, where the config has one,
    the dense residual branch beside them."""

    def __init__(self, cfg: TransformerConfig, window: Optional[int], *,
                 device=None, dtype=None):
        super().__init__()
        d, H, Hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff)
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.window = window
        self.ln1 = _weight(d, **kw)
        self.ln2 = _weight(d, **kw)
        self.wq = _weight(d, H * dh, **kw)
        self.wk = _weight(d, Hk * dh, **kw)
        self.wv = _weight(d, Hk * dh, **kw)
        self.wo = _weight(H * dh, d, **kw)
        if cfg.moe is None:
            self.w_gate = _weight(d, f, **kw)
            self.w_up = _weight(d, f, **kw)
            self.w_down = _weight(f, d, **kw)
            return
        self.moe = MoE(d, cfg.moe, **kw)
        fr = cfg.moe.dense_residual_d_ff
        if fr:
            self.res_gate = _weight(d, fr, **kw)
            self.res_up = _weight(d, fr, **kw)
            self.res_down = _weight(fr, d, **kw)


class Transformer(nn.Module):
    """The weights of a config, in one dtype on one device (CUDA unless
    ``device`` says otherwise); layer ``g * P + i`` runs pattern entry
    ``i``'s window.  They are zeros until
    :func:`repro_torch.params.load_transformer` fills them or
    :func:`repro_torch.params.draw_transformer` draws them from a seed."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.embed = _weight(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = _weight(cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.window_pattern[n % len(cfg.window_pattern)],
                         **kw)
            for n in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = _weight(cfg.d_model, cfg.vocab, **kw)

    def unembed_weight(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


# ---------------------------------------------------------------------------
# Sharding: the spec trees and one rank's view
# ---------------------------------------------------------------------------

def _tp_heads(cfg: TransformerConfig, policy) -> bool:
    return cfg.n_heads % policy.tp == 0 and cfg.n_kv_heads % policy.tp == 0


def param_pspecs(cfg: TransformerConfig, policy) -> dict:
    """Spec tree matching the reference layout (each entry an axis name or
    None per dim, the reference's ``PartitionSpec`` entries)."""
    tp = policy.tp_axis
    hspec = tp if _tp_heads(cfg, policy) else None

    def block_spec() -> dict:
        blk = {
            "ln1": (None, None), "ln2": (None, None),
            "wq": (None, None, hspec),
            "wk": (None, None, hspec),
            "wv": (None, None, hspec),
            "wo": (None, hspec, None),
        }
        if cfg.moe is not None:
            blk["moe"] = {
                "router": (None, None, None),
                "w_gate": (None, tp, None, None),
                "w_up": (None, tp, None, None),
                "w_down": (None, tp, None, None),
            }
            if cfg.moe.dense_residual_d_ff:
                blk["res_gate"] = (None, None, tp)
                blk["res_up"] = (None, None, tp)
                blk["res_down"] = (None, tp, None)
        else:
            blk["w_gate"] = (None, None, tp)
            blk["w_up"] = (None, None, tp)
            blk["w_down"] = (None, tp, None)
        return blk

    vocab = cfg.vocab % policy.tp == 0
    specs = {
        "embed": (tp, None) if vocab else (None, None),
        "final_norm": (None,),
        "blocks": [block_spec() for _ in cfg.window_pattern],
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = (None, tp) if vocab else (None, None)
    return specs


class ShardedTransformer:
    """One rank's slices of a transformer's weights under ``policy``, by
    :func:`param_pspecs`: ``embed`` (and ``unembed``), ``final_norm`` and
    one object per layer holding the reference's names (``moe`` a dict),
    in one dtype on one device.  ``repro_torch.params.shard_transformer``
    builds it; the serving functions take it in place of a
    :class:`Transformer` when given the same ``policy``."""

    def __init__(self, cfg: TransformerConfig, policy, embed: torch.Tensor,
                 final_norm: torch.Tensor, layers: list,
                 unembed: Optional[torch.Tensor] = None):
        if cfg.moe is not None and cfg.moe.n_experts % policy.tp:
            raise ValueError(f"{cfg.name}: {cfg.moe.n_experts} experts do "
                             f"not shard over tp={policy.tp}")
        self.cfg, self.policy = cfg, policy
        self.embed, self.final_norm, self.layers = embed, final_norm, layers
        self.unembed = unembed

    def unembed_weight(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


class _RankView:
    """What one rank's program needs of the policy: its groups, its
    coordinates, its local head counts, and the collectives around the
    column- and row-parallel products."""

    def __init__(self, cfg: TransformerConfig, policy):
        self.policy = policy
        self.tp = policy.tp
        self.tp_group = policy.group(policy.tp_axis)
        self.ti = policy.coord(policy.tp_axis)
        self.sp = policy.seq_parallel_residual
        self.tp_heads = _tp_heads(cfg, policy)
        div = self.tp if self.tp_heads else 1
        self.n_heads, self.n_kv = cfg.n_heads // div, cfg.n_kv_heads // div
        self.vocab = cfg.vocab % self.tp == 0

    def batch(self, t: torch.Tensor, axes) -> torch.Tensor:
        """This rank's slice along dim 0 over ``axes``."""
        n = self.policy.size(axes) if axes else 1
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} over {n} ranks")
        b = t.shape[0] // n
        lo = self.policy.coord(axes) * b if axes else 0
        return t[lo:lo + b]

    def seq_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence shard of a full-sequence ``x``."""
        s = x.shape[1] // self.tp
        return x[:, self.ti * s:(self.ti + 1) * s]

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The residual layout -> the full sequence (before a
        column-parallel product)."""
        return comm.all_gather(x, self.tp_group, 1) if self.sp else x

    def reduce_out(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums -> the residual layout."""
        if self.sp:
            return comm.reduce_scatter(partial, self.tp_group, 1)
        return comm.all_reduce(partial, self.tp_group)

    def embed(self, model, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B_l, S) -> the residual layout, vocab-parallel where the
        vocabulary shards: a masked local lookup, summed over ``tp``."""
        # F.embedding: its backward sums the rows in a fixed order.
        if not self.vocab:
            x = F.embedding(tokens.long(), model.embed)
            return self.seq_slice(x) if self.sp else x
        rows = model.embed.shape[0]
        loc = tokens.long() - self.ti * rows
        ok = (loc >= 0) & (loc < rows)
        part = F.embedding(loc.clamp(0, rows - 1), model.embed) * ok[
            ..., None].to(model.embed.dtype)
        return self.reduce_out(part)

    def logits(self, cfg: TransformerConfig, model,
               x: torch.Tensor) -> torch.Tensor:
        """Normed hidden (B_l, S', d) -> logits: this rank's vocabulary
        columns where the vocabulary shards, else all of them."""
        logits = rms_norm(x, model.final_norm) @ model.unembed_weight()
        if cfg.final_softcap is not None:
            logits = softcap(logits, cfg.final_softcap)
        return logits

    def full_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(logits, self.tp_group, -1) if self.vocab \
            else logits

    def attention(self, cfg: TransformerConfig, layer, x: torch.Tensor,
                  freqs: torch.Tensor, attend):
        """x + the attention block's output, and the layer's roped keys and
        values: the rank's heads over the full sequence (tensor parallel),
        or all heads over the full sequence (context parallel)."""
        h = rms_norm(x, layer.ln1)
        if self.tp_heads:
            hf = self.gather_seq(h)
            b, s, _ = hf.shape
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None]
            q, k, v = _project_qkv(cfg, layer, hf, positions, freqs,
                                   self.n_heads, self.n_kv)
            out = attend(cfg, layer, q, k, v)
            part = out.reshape(b, s, self.n_heads * cfg.d_head) @ layer.wo
            return x + self.reduce_out(part), k, v
        hl = h if self.sp else self.seq_slice(h)
        b, s_loc, _ = hl.shape
        offset = self.ti * s_loc
        positions = (offset + torch.arange(s_loc, dtype=torch.int32,
                                           device=x.device))[None]
        q, k, v = _project_qkv(cfg, layer, hl, positions, freqs,
                               cfg.n_heads, cfg.n_kv_heads)
        kg = comm.all_gather(k, self.tp_group, 1)
        vg = comm.all_gather(v, self.tp_group, 1)
        out = attn_lib.chunked_causal_attention(
            q, kg, vg, window=layer.window, attn_softcap=cfg.attn_softcap,
            q_chunk=min(cfg.q_chunk, s_loc), q_offset=offset)
        out = out.reshape(b, s_loc, cfg.n_heads * cfg.d_head) @ layer.wo
        if not self.sp:
            out = comm.all_gather(out, self.tp_group, 1)
        return x + out, kg, vg

    def full_kv(self, t: torch.Tensor) -> torch.Tensor:
        """A layer's keys or values (from :meth:`attention`) -> every kv
        head."""
        return comm.all_gather(t, self.tp_group, 2) if self.tp_heads else t

    def ffn(self, cfg: TransformerConfig, layer, x: torch.Tensor):
        """x + the FFN block's output, and the MoE balance loss (None for a
        dense config)."""
        h = rms_norm(x, layer.ln2)
        if cfg.moe is None:
            part = swiglu(self.gather_seq(h), layer.w_gate, layer.w_up,
                          layer.w_down)
            return x + self.reduce_out(part), None
        hl = h if self.sp else self.seq_slice(h)
        b, s, d = hl.shape
        out, aux = moe_lib.moe_ffn_ep(layer.moe, hl.reshape(b * s, d),
                                      cfg.moe, group=self.tp_group)
        # Replicated over every rank (routing differs per data shard).
        everyone = self.policy.group(self.policy.all_axes)
        aux = comm.all_reduce(aux, everyone) / self.policy.n_devices
        out = out.reshape(b, s, d)
        if not self.sp:
            out = comm.all_gather(out, self.tp_group, 1)
        if cfg.moe.dense_residual_d_ff:
            out = out + self.reduce_out(swiglu(
                self.gather_seq(h), layer.res_gate, layer.res_up,
                layer.res_down))
        return x + out, aux


def _project_qkv(cfg: TransformerConfig, layer, h: torch.Tensor,
                 positions: torch.Tensor, freqs: torch.Tensor, n_heads: int,
                 n_kv: int):
    b, s, _ = h.shape
    q = (h @ layer.wq).reshape(b, s, n_heads, cfg.d_head)
    k = (h @ layer.wk).reshape(b, s, n_kv, cfg.d_head)
    v = (h @ layer.wv).reshape(b, s, n_kv, cfg.d_head)
    return apply_rope(q, positions, freqs), apply_rope(k, positions, freqs), v


def _qkv(cfg: TransformerConfig, layer: DecoderLayer, x: torch.Tensor,
         positions: torch.Tensor, freqs: torch.Tensor):
    return _project_qkv(cfg, layer, rms_norm(x, layer.ln1), positions, freqs,
                        cfg.n_heads, cfg.n_kv_heads)


def _ffn(cfg: TransformerConfig, layer: DecoderLayer, x: torch.Tensor, *,
         decode: bool = False):
    """The FFN block: (x + its output, the MoE balance loss or None).  An
    MoE layer routes all ``B * S`` tokens in one call: the capacity dispatch
    in a prefill, every expert in a decode step."""
    h = rms_norm(x, layer.ln2)
    if cfg.moe is None:
        return x + swiglu(h, layer.w_gate, layer.w_up, layer.w_down), None
    b, s, d = h.shape
    moe_ffn = (moe_lib.moe_ffn_reference if decode
               else moe_lib.moe_ffn_capacity)
    out, aux = moe_ffn(layer.moe, h.reshape(b * s, d), cfg.moe)
    out = out.reshape(b, s, d)
    if cfg.moe.dense_residual_d_ff:
        out = out + swiglu(h, layer.res_gate, layer.res_up, layer.res_down)
    return x + out, aux


def _logits(cfg: TransformerConfig, model: Transformer,
            x: torch.Tensor) -> torch.Tensor:
    logits = rms_norm(x, model.final_norm) @ model.unembed_weight()
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _k5_attention(cfg: TransformerConfig, layer, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Serving attention: K5 (``ops.flash_attention``)."""
    return ops.flash_attention(q, k, v, causal=True, window=layer.window,
                               softcap=cfg.attn_softcap)


def _chunked_attention(cfg: TransformerConfig, layer, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Training attention: the reference's chunked path, differentiable."""
    return attn_lib.chunked_causal_attention(
        q, k, v, window=layer.window, attn_softcap=cfg.attn_softcap,
        q_chunk=cfg.q_chunk)


def _positions(cfg: TransformerConfig, s: int, device):
    positions = torch.arange(s, dtype=torch.int32, device=device)[None]
    return positions, rope_freqs(cfg.d_head, theta=cfg.rope_theta,
                                 device=device)


def _layers(cfg: TransformerConfig, layers, x: torch.Tensor,
            positions: torch.Tensor, freqs: torch.Tensor, attend,
            on_kv=None, rank: Optional[_RankView] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The one layer loop, for serving and training alike: ``x`` through
    ``layers``, attention through ``attend(cfg, layer, q, k, v)`` (K5 in
    serving, the chunked path in training), then the FFN.  Returns (x, the
    layers' MoE balance losses summed in fp32, 0 for a dense config);
    ``on_kv(n, k, v)`` receives the n-th layer's roped keys and values
    (B, S, Hk, d_head).  With a ``rank`` view, ``x`` is the rank's residual
    layout and each block runs sharded (:class:`_RankView`); ``on_kv`` then
    receives the rank's keys and values as :meth:`_RankView.attention`
    returns them."""
    b, s, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n, layer in enumerate(layers):
        if rank is not None:
            x, k, v = rank.attention(cfg, layer, x, freqs, attend)
            x, a = rank.ffn(cfg, layer, x)
        else:
            q, k, v = _qkv(cfg, layer, x, positions, freqs)
            out = attend(cfg, layer, q, k, v)
            x = x + out.reshape(b, s, cfg.n_heads * cfg.d_head) @ layer.wo
            x, a = _ffn(cfg, layer, x)
        if on_kv is not None:
            on_kv(n, k, v)
        if a is not None:
            aux = aux + a
    return x, aux


def _rank_view(cfg: TransformerConfig, model, policy):
    if policy is None:
        return None
    if not isinstance(model, ShardedTransformer) or model.policy is not policy:
        raise TypeError("a policy path takes the ShardedTransformer built "
                        "for that policy (params.shard_transformer)")
    return _RankView(cfg, policy)


def _prefill_layers(cfg: TransformerConfig, model, tokens: torch.Tensor,
                    on_kv=None, rank: Optional[_RankView] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The serving pass: (the residual stream after every layer, the MoE
    balance loss), K5 on every layer (on the rank's heads under tensor
    parallelism; context parallelism takes the chunked path); ``on_kv`` as
    in :func:`_layers`.  With a ``rank`` view, ``tokens`` is the rank's
    batch slice (B_l, S)."""
    if rank is not None:
        x = rank.embed(model, tokens)
        freqs = rope_freqs(cfg.d_head, theta=cfg.rope_theta, device=x.device)
        return _layers(cfg, model.layers, x, None, freqs, _k5_attention,
                       on_kv, rank)
    x = model.embed[tokens.long()]
    positions, freqs = _positions(cfg, tokens.shape[1], x.device)
    return _layers(cfg, model.layers, x, positions, freqs, _k5_attention,
                   on_kv)


@torch.inference_mode()
def forward_hidden(cfg: TransformerConfig, model, tokens: torch.Tensor, *,
                   policy=None):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux_loss): the MoE
    balance loss summed over the layers in fp32, 0 for a dense config.

    Under ``policy`` every rank passes the same tokens and ``model`` is its
    :class:`ShardedTransformer`; the hidden is the rank's block of the
    residual layout (``policy.act_spec()``), the loss the global one."""
    rank = _rank_view(cfg, model, policy)
    if rank is not None:
        tokens = rank.batch(tokens, policy.dp_axes)
    x, aux = _prefill_layers(cfg, model, tokens, rank=rank)
    return rms_norm(x, model.final_norm), aux


@torch.inference_mode()
def forward(cfg: TransformerConfig, model, tokens: torch.Tensor, *,
            policy=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  S must meet K5's block contract
    (S <= 128 or S % 128 == 0).  The reference returns the MoE balance loss
    beside the logits; here :func:`forward_hidden` does.

    Under ``policy`` every rank passes the same tokens and gets its block of
    the logits: its batch slice, all of the sequence and its vocabulary
    columns where the vocabulary divides ``tp`` (the reference's
    vocab-parallel logits), else its residual block of positions and every
    column.  :func:`gather_logits` assembles them."""
    rank = _rank_view(cfg, model, policy)
    if rank is None:
        return _logits(cfg, model, _prefill_layers(cfg, model, tokens)[0])
    x, _ = _prefill_layers(cfg, model, rank.batch(tokens, policy.dp_axes),
                           rank=rank)
    if rank.vocab:
        x = rank.gather_seq(x)
    return rank.logits(cfg, model, x)


def gather_logits(cfg: TransformerConfig, logits: torch.Tensor,
                  policy) -> torch.Tensor:
    """Every rank's block of :func:`forward`'s logits -> the global (B, S,
    V) logits on every rank (all-gathers, recorded like any other)."""
    rank = _RankView(cfg, policy)
    if rank.vocab:
        logits = comm.all_gather(logits, rank.tp_group, 2)
    elif rank.sp:
        logits = comm.all_gather(logits, rank.tp_group, 1)
    return comm.all_gather(logits, policy.group(policy.dp_axes), 0)


# ---------------------------------------------------------------------------
# Training: loss and train step over a reference-layout tree of tensors
# ---------------------------------------------------------------------------

def _tree_entries(cfg: TransformerConfig, params: dict) -> list:
    """Per pattern entry of a reference-layout tree: each weight's (G, ...)
    stack cast to the compute dtype (whole, then unbound into its G slices:
    the backward stacks the slices' gradients)."""
    cdt = cfg.compute_dtype

    def cast(a: torch.Tensor) -> tuple:
        if a.dtype in (torch.float32, torch.bfloat16):
            a = a.to(cdt)
        return a.unbind(0)

    entries = []
    for blk in params["blocks"]:
        entry = {key: cast(blk[key]) for key in layer_keys(cfg)}
        if cfg.moe is not None:
            entry["moe"] = {key: cast(blk["moe"][key]) for key in MOE_KEYS}
        entries.append(entry)
    return entries


def _entry_layer(cfg: TransformerConfig, entry: dict, i: int, g: int,
                 get=None) -> SimpleNamespace:
    """Layer ``g * P + i``: slice ``g`` of pattern entry ``i``'s weights,
    each through ``get(path, slice)`` when given (the FSDP gather)."""
    get = get or (lambda path, t: t)
    layer = SimpleNamespace(window=cfg.window_pattern[i],
                            **{k: get((k,), entry[k][g])
                               for k in layer_keys(cfg)})
    if cfg.moe is not None:
        layer.moe = {k: get(("moe", k), entry["moe"][k][g])
                     for k in MOE_KEYS}
    return layer


def _tree_layers(cfg: TransformerConfig, params: dict) -> list:
    """Layer ``g * P + i`` of a reference-layout tree: block ``i``'s slice
    ``g`` of every weight, cast to the compute dtype.

    The GNNs and DLRM bind a tree to their module with
    ``params.tree_loss`` (``torch.func.functional_call``).
    ``functional_call`` swaps the tree in only for the call, and the group
    remat recomputes each group in the backward pass, after the call has
    returned, so a recompute through the module would read its own weights
    and give wrong gradients without an error (the GNNs' layers bind the
    tree's tensors again for theirs: ``common.checkpoint_layer``).  The
    layers here are plain objects that the recompute's closures hold."""
    entries = _tree_entries(cfg, params)
    P = len(cfg.window_pattern)
    return [_entry_layer(cfg, entries[n % P], n % P, n // P)
            for n in range(cfg.n_layers)]


def _run_groups(cfg: TransformerConfig, group, x: torch.Tensor):
    """``group(x, g) -> (x, aux)`` over the decoder groups, each under
    ``torch.utils.checkpoint`` unless ``cfg.remat`` is ``"none"``; the
    balance losses summed in fp32."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        if cfg.remat == "none":
            x, a = group(x, g)
        else:
            x, a = checkpoint(group, x, g, use_reentrant=False)
        aux = aux + a
    return x, aux


def _train_hidden(cfg: TransformerConfig, params: dict,
                  tokens: torch.Tensor):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux_loss): the
    reference's ``forward_hidden`` over a tree, differentiable."""
    cdt = cfg.compute_dtype
    # F.embedding: its backward sums the rows in a fixed order on both
    # devices (indexing's backward accumulates them in no fixed order).
    x = F.embedding(tokens.long(), params["embed"].to(cdt))
    positions, freqs = _positions(cfg, tokens.shape[1], x.device)
    layers = _tree_layers(cfg, params)
    P = len(cfg.window_pattern)

    def group(x: torch.Tensor, g: int):
        return _layers(cfg, layers[g * P:(g + 1) * P], x, positions, freqs,
                       _chunked_attention)

    x, aux = _run_groups(cfg, group, x)
    return rms_norm(x, params["final_norm"].to(cdt)), aux


def _unembed_weight(cfg: TransformerConfig, params: dict) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return w.to(cfg.compute_dtype)


#: (B*S*V) elements above which the loss switches to sequence-chunked CE:
#: the (B, S, V) logits (and their gradient) would otherwise dominate
#: memory at a 32k+ vocabulary.
_CE_CHUNK_THRESHOLD = 1 << 24
_CE_CHUNK = 256


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         rank: Optional[_RankView] = None) -> torch.Tensor:
    """Per-token negative log-likelihood in fp32.  With a vocab-parallel
    ``rank`` the logits are its vocabulary columns: the logsumexp combines
    the ranks' from an all-reduce max and an all-reduce sum, and the gold
    logit is a masked local gather summed over ``tp``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if rank is None:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return logz - gold
    rows = logits.shape[-1]
    loc = labels.long() - rank.ti * rows
    ok = (loc >= 0) & (loc < rows)
    gold = torch.gather(logits, -1, loc.clamp(0, rows - 1)[..., None])[
        ..., 0] * ok.to(logits.dtype)
    if rank.tp > 1:
        m = comm.all_reduce(logz.detach(), rank.tp_group, "max", tag="ce")
        logz = m + torch.log(comm.all_reduce(torch.exp(logz - m),
                                             rank.tp_group, tag="ce"))
        gold = comm.all_reduce(gold, rank.tp_group, tag="ce")
    return logz - gold


def _ce_token_nll(cfg: TransformerConfig, x_chunk: torch.Tensor,
                  unembed: torch.Tensor, labels_chunk: torch.Tensor,
                  rank: Optional[_RankView] = None) -> torch.Tensor:
    """(B, c, d) -> the summed nll over one sequence chunk, fp32."""
    logits = x_chunk @ unembed
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return torch.sum(_nll(logits, labels_chunk, rank))


def _chunked_ce(cfg: TransformerConfig, x: torch.Tensor,
                unembed: torch.Tensor, labels: torch.Tensor,
                rank: Optional[_RankView] = None) -> torch.Tensor:
    """The summed nll of one sequence chunk at a time, each chunk's logits
    rematerialised in the backward pass."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[1], _CE_CHUNK):
        total = total + checkpoint(
            _ce_token_nll, cfg, x[:, lo:lo + _CE_CHUNK], unembed,
            labels[:, lo:lo + _CE_CHUNK], rank, use_reentrant=False)
    return total


def _chunks_ce(cfg: TransformerConfig, b: int, s: int) -> bool:
    """The reference's rule: chunk the CE past the threshold when the
    sequence divides into chunks (``b`` is the global batch)."""
    return not (b * s * cfg.vocab <= _CE_CHUNK_THRESHOLD or s % _CE_CHUNK)


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict, *,
            policy=None, specs: Optional[dict] = None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy plus the MoE balance loss, over a
    reference-layout tree of tensors; ``(loss, {"loss", "ce", "aux"})``.
    ``batch``: int ``tokens`` and ``labels`` (B, S), optionally a ``mask``
    (the unchunked path on one device only, as in the reference).

    Under ``policy`` every rank passes the same batch and its blocks of the
    tree, laid out by ``specs`` (default :func:`train_pspecs` in the
    tree's dtype); the first value is this rank's objective, whose
    gradients :func:`make_train_step` makes whole, and the metrics are the
    global loss, cross-entropy and balance loss."""
    if policy is not None:
        return _policy_loss(cfg, params, batch, policy, specs)
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    x, aux = _train_hidden(cfg, params, tokens)
    unembed = _unembed_weight(cfg, params)
    if not _chunks_ce(cfg, b, s):
        logits = x @ unembed
        if cfg.final_softcap is not None:
            logits = softcap(logits, cfg.final_softcap)
        ce = cross_entropy_loss(logits, labels, mask=batch.get("mask"))
    else:
        ce = _chunked_ce(cfg, x, unembed, labels) / (b * s)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def make_train_step(cfg: TransformerConfig, optimizer, *, policy=None,
                    specs: Optional[dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the reference's signature over ``optimizers.make_step`` of
    :func:`loss_fn`: gradients by autograd, then the optimizer's update,
    applied in place when ``optimizer.donate``.

    Under ``policy`` each rank passes its blocks of the parameters and of
    the moments (``specs``, default :func:`train_pspecs` in the
    parameters' dtype) and the same global batch; between the backward
    and the update the gradients are made whole and the clipping reads
    their global norm (:func:`_sync_grads`)."""
    sync = None
    if policy is not None:
        sync = partial(_sync_grads, cfg, policy, specs)
    step_fn = make_step(partial(loss_fn, cfg, policy=policy, specs=specs),
                        optimizer, sync=sync)

    def train_step(params, opt_state, batch):
        (params, opt_state), metrics = step_fn((params, opt_state), batch)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Training under a policy
# ---------------------------------------------------------------------------

def _param_shapes(cfg: TransformerConfig) -> dict:
    """The reference layout's global shapes (tuples as leaves)."""
    d, H, Hk, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    G = cfg.n_groups

    def ffn(width: int, prefix: str) -> dict:
        return {f"{prefix}gate": (G, d, width), f"{prefix}up": (G, d, width),
                f"{prefix}down": (G, width, d)}

    def block() -> dict:
        blk = {"ln1": (G, d), "ln2": (G, d), "wq": (G, d, H * dh),
               "wk": (G, d, Hk * dh), "wv": (G, d, Hk * dh),
               "wo": (G, H * dh, d)}
        if cfg.moe is None:
            return {**blk, **ffn(f, "w_")}
        E, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        blk["moe"] = {"router": (G, d, E), "w_gate": (G, E, d, fe),
                      "w_up": (G, E, d, fe), "w_down": (G, E, fe, d)}
        if cfg.moe.dense_residual_d_ff:
            blk.update(ffn(cfg.moe.dense_residual_d_ff, "res_"))
        return blk

    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,),
              "blocks": [block() for _ in cfg.window_pattern]}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab)
    return shapes


def abstract_params(cfg: TransformerConfig, *,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The reference layout as ``meta`` tensors of the global shapes in
    ``dtype``: nothing is allocated."""
    return tree_map(lambda shape: torch.empty(shape, dtype=dtype,
                                              device="meta"),
                    _param_shapes(cfg), is_leaf=is_spec)


def train_pspecs(cfg: TransformerConfig, policy, *,
                 dtype: torch.dtype = torch.float32,
                 min_bytes: int = 1 << 20) -> dict:
    """The training state's layout, the reference's ``_lm_plan``:
    :func:`param_pspecs` with every leaf of at least ``min_bytes`` (in
    ``dtype``) also sharded over the dp axes (``sharding.fsdp_specs``).
    AdamW's moments take the same layout."""
    return fsdp_specs(abstract_params(cfg, dtype=dtype),
                      param_pspecs(cfg, policy), policy, min_bytes=min_bytes)


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _Fsdp:
    """The FSDP side of one rank's training pass: which dim of each leaf
    is split over dp (by ``specs``), and the tagged all-gather over the dp
    group that rebuilds the rank's tensor-parallel block on use."""

    def __init__(self, policy, specs: dict):
        self.policy, self.specs = policy, specs
        self.group = policy.group(policy.dp_axes) if policy.dp > 1 else None

    def dim(self, spec: tuple) -> Optional[int]:
        for d, entry in enumerate(spec):
            if entry == self.policy.dp_spec:
                return d
        return None

    def gather(self, t: torch.Tensor, spec: tuple,
               stacked: bool = False) -> torch.Tensor:
        """``t`` (a leaf, or with ``stacked`` one layer's slice of a
        (G, ...) leaf) gathered along its FSDP dim, if it has one."""
        d = self.dim(spec) if self.group is not None else None
        if d is None:
            return t
        if stacked:
            if d == 0:
                raise ValueError(f"FSDP over the layer dim of {spec}: a "
                                 "layer's slice cannot be gathered alone")
            d -= 1
        return comm.all_gather(t, self.group, d, tag="fsdp")


def _check_blocks(cfg: TransformerConfig, params: dict, specs: dict,
                  policy) -> None:
    """Each leaf must be this rank's block of the global shape by its
    spec."""
    want = dict(tree_paths(_param_shapes(cfg), is_spec))
    laid = dict(tree_paths(specs, is_spec))
    for path, leaf in tree_paths(params, is_spec):
        shape = tuple(want[path])
        spec = laid[path]
        for d, entry in enumerate(spec):
            if entry is not None:
                shape = shape[:d] + (shape[d] // policy.size(entry),) + \
                    shape[d + 1:]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{path}: a block of {tuple(leaf.shape)}, "
                             f"expected {shape} by the spec {spec}")


def _resolve_specs(cfg: TransformerConfig, params: dict, policy,
                   specs: Optional[dict]) -> dict:
    if specs is None:
        specs = train_pspecs(cfg, policy, dtype=params["embed"].dtype)
    _check_blocks(cfg, params, specs, policy)
    return specs


def _policy_loss(cfg: TransformerConfig, params: dict, batch: dict, policy,
                 specs: Optional[dict]) -> tuple[torch.Tensor, dict]:
    """One rank's objective and the global metrics (:func:`loss_fn`)."""
    if batch.get("mask") is not None:
        raise ValueError("a loss mask is taken on one device only")
    rank = _RankView(cfg, policy)
    if not rank.sp:
        raise ValueError("training under a policy runs the "
                         "sequence-parallel residual "
                         "(seq_parallel_residual=True)")
    specs = _resolve_specs(cfg, params, policy, specs)
    fsdp = _Fsdp(policy, specs)
    cdt = cfg.compute_dtype
    b_all, s = batch["tokens"].shape
    tokens = rank.batch(batch["tokens"], policy.dp_axes)
    labels = rank.batch(batch["labels"], policy.dp_axes)
    b = tokens.shape[0]

    # The top-level leaves are gathered once, in the stored dtype, and cast
    # for each use: the tied embedding's two gradients then add in the
    # stored dtype, as on one device.
    embed = fsdp.gather(params["embed"], specs["embed"])
    x = rank.embed(SimpleNamespace(embed=embed.to(cdt)), tokens)
    freqs = rope_freqs(cfg.d_head, theta=cfg.rope_theta, device=x.device)
    entries = _tree_entries(cfg, params)
    P = len(cfg.window_pattern)

    def group(x: torch.Tensor, g: int):
        layers = []
        for i in range(P):
            spec = specs["blocks"][i]
            get = lambda path, t, spec=spec: fsdp.gather(  # noqa: E731
                t, spec[path[0]] if len(path) == 1 else spec["moe"][path[1]],
                stacked=True)
            layers.append(_entry_layer(cfg, entries[i], i, g, get))
        return _layers(cfg, layers, x, None, freqs, _chunked_attention,
                       rank=rank)

    x, aux = _run_groups(cfg, group, x)
    x = rms_norm(x, fsdp.gather(params["final_norm"],
                                specs["final_norm"]).to(cdt))
    unembed = (embed.T if cfg.tie_embeddings else fsdp.gather(
        params["unembed"], specs["unembed"])).to(cdt)
    chunked = _chunks_ce(cfg, b_all, s)
    if rank.vocab:
        # Vocab-parallel: the whole sequence, this rank's columns.
        x = rank.gather_seq(x)
        if chunked:
            ce = _chunked_ce(cfg, x, unembed, labels, rank) / (b * s)
        else:
            logits = x @ unembed
            if cfg.final_softcap is not None:
                logits = softcap(logits, cfg.final_softcap)
            ce = torch.mean(_nll(logits, labels, rank))
    else:
        # Every column on the rank's sequence shard, summed over tp.
        labels = rank.seq_slice(labels)
        if chunked and labels.shape[1] % _CE_CHUNK == 0:
            part = _chunked_ce(cfg, x, unembed, labels)
        else:
            part = _ce_token_nll(cfg, x, unembed, labels)
        ce = comm.all_reduce(part, rank.tp_group, tag="ce") / (b * s)
    dp_group = policy.group(policy.dp_axes)
    ce_all = comm.all_reduce(ce.detach(), dp_group, tag="metrics") / policy.dp
    aux_all = aux.detach()
    # The balance loss is averaged over every rank on its way out of each
    # layer (two all-reduces whose backward passes the gradient through),
    # and the dp mean of the gradients divides once more: the factor puts
    # each rank's share of its gradient back at 1 / n_devices.
    objective = ce + _GradScale.apply(aux, policy.n_devices)
    loss_all = ce_all + aux_all
    return objective, {"loss": loss_all, "ce": ce_all, "aux": aux_all}


def _tp_partial(cfg: TransformerConfig, policy) -> set:
    """Paths of the leaves replicated over ``tp`` whose inputs are sharded
    over it, so that each rank holds a part of their gradient: the
    sequence-parallel residual's norms, the context-parallel path's
    attention weights, the MoE router, and the embedding (and unembedding)
    where the vocabulary does not shard."""
    keys = {"ln1", "ln2"}
    if not _tp_heads(cfg, policy):
        keys |= {"wq", "wk", "wv", "wo"}
    out = {("final_norm",)}
    for i in range(len(cfg.window_pattern)):
        out |= {("blocks", i, k) for k in keys}
        if cfg.moe is not None:
            out.add(("blocks", i, "moe", "router"))
    if cfg.vocab % policy.tp:
        out |= {("embed",), ("unembed",)}
    return out


def _sync_grads(cfg: TransformerConfig, policy, specs: Optional[dict],
                grads: dict) -> torch.Tensor:
    """One rank's gradients made whole, in place: the partial ones
    (:func:`_tp_partial`) summed over ``tp``; the leaves replicated over
    dp averaged over it (``comm.all_reduce_grads``, tagged ``"grad_dp"``),
    the FSDP ones (summed by their gathers' reduce-scatters) divided by
    dp.  Returns the global norm."""
    specs = _resolve_specs(cfg, grads, policy, specs)
    laid = dict(tree_paths(specs, is_spec))
    partial_paths = _tp_partial(cfg, policy)
    dp = set(policy.dp_axes)
    tp_sum, dp_mean, fsdp = [], [], []
    for path, g in tree_paths(grads, is_spec):
        spec_axes = set(sharding_axes(laid[path], policy))
        if path in partial_paths:
            tp_sum.append(g)
        (fsdp if spec_axes & dp else dp_mean).append(g)
    if policy.tp > 1 and tp_sum:
        comm.all_reduce_grads(tp_sum, policy.group(policy.tp_axis),
                              tag="grad_tp")
    if policy.dp > 1:
        comm.all_reduce_grads(dp_mean, policy.group(policy.dp_axes),
                              mean=True, tag="grad_dp")
        for g in fsdp:
            g.div_(policy.dp)
    return sharded_global_norm(grads, specs, policy)


@dataclass(frozen=True)
class DecodePolicy:
    """How the KV cache is laid out on the mesh.

    cache_seq_axes: mesh axes sharding the cache sequence dimension.  decode
    shapes use ("model",); the 500k single-sequence shape uses ("data",
    "model") so 256 devices each hold 2k slots.
    batch_axes: axes sharding the decode batch (() when batch == 1).
    """

    cache_seq_axes: tuple[str, ...] = ("model",)
    batch_axes: tuple[str, ...] = ("data",)


def cache_shapes(cfg: TransformerConfig, batch: int,
                 max_seq: int) -> list[tuple]:
    """Per-pattern-entry cache shapes (G, B, S_entry, Hk, d_head)."""
    return [(cfg.n_groups, batch,
             min(window, max_seq) if window is not None else max_seq,
             cfg.n_kv_heads, cfg.d_head) for window in cfg.window_pattern]


def abstract_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """The caches of :func:`init_cache` as ``meta`` tensors of the global
    shapes, in the compute dtype unless ``dtype`` says otherwise."""
    dtype = dtype or cfg.compute_dtype
    out = {}
    for i, shape in enumerate(cache_shapes(cfg, batch, max_seq)):
        out[f"k{i}"] = torch.empty(shape, dtype=dtype, device="meta")
        out[f"v{i}"] = torch.empty(shape, dtype=dtype, device="meta")
    return out


def cache_pspecs(cfg: TransformerConfig, policy,
                 decode: DecodePolicy) -> dict:
    """The cache's spec per entry: (None, batch axes, sequence axes, None,
    None)."""
    seq = decode.cache_seq_axes if len(decode.cache_seq_axes) > 1 else (
        decode.cache_seq_axes[0] if decode.cache_seq_axes else None)
    bat = decode.batch_axes if len(decode.batch_axes) > 1 else (
        decode.batch_axes[0] if decode.batch_axes else None)
    spec = (None, bat, seq, None, None)
    out = {}
    for i in range(len(cfg.window_pattern)):
        out[f"k{i}"] = spec
        out[f"v{i}"] = spec
    return out


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
               dtype: Optional[torch.dtype] = None, device=None,
               policy=None, decode: Optional[DecodePolicy] = None) -> dict:
    """Zeroed caches ``{"k{i}", "v{i}"}`` per pattern entry ``i``, in the
    compute dtype, on CUDA unless ``device`` says otherwise.  Under
    ``policy`` (with ``decode``, default :class:`DecodePolicy`), this rank's
    block of the global caches by :func:`cache_pspecs`."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    cache = {}
    for i, shape in enumerate(cache_shapes(cfg, batch, max_seq)):
        if policy is not None:
            shape = _local_cache_shape(shape, policy,
                                       decode or DecodePolicy())
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _local_cache_shape(shape: tuple, policy, decode: DecodePolicy) -> tuple:
    g, b, s, hk, dh = shape
    nb = policy.size(decode.batch_axes) if decode.batch_axes else 1
    ns = policy.size(decode.cache_seq_axes) if decode.cache_seq_axes else 1
    if b % nb or s % ns:
        raise ValueError(f"cache (B {b}, S {s}) over {nb} x {ns} ranks")
    return (g, b // nb, s // ns, hk, dh)


def _seq_block(policy, decode: DecodePolicy, s_entry: int) -> tuple:
    """(this rank's first slot, its slot count) of an entry's sequence,
    and the group of the sequence shards (None for one shard)."""
    axes = decode.cache_seq_axes
    if not axes:
        return 0, s_entry, None
    s_loc = s_entry // policy.size(axes)
    return policy.coord(axes) * s_loc, s_loc, policy.group(axes)


def make_prefill_step(cfg: TransformerConfig, *,
                      max_seq: Optional[int] = None, policy=None,
                      decode: DecodePolicy = DecodePolicy()):
    """Returns prefill(model, tokens (B, S)) -> (last logits (B, V), cache).

    One inference prefill: the forward pass plus the KV cache, sized for
    ``max_seq`` positions (default S) so decode continues at pos = S.  A
    windowed entry keeps the last ``window`` positions in ring layout (slot
    ``p % window`` holds position p); a longer entry is zero past S.

    Under ``policy`` every rank passes the same tokens and its
    :class:`ShardedTransformer`, and gets its batch slice (over the dp
    axes) of the logits, every column, and its block of the cache in
    ``decode``'s layout, which :func:`make_serve_step` with the same
    policies continues (``decode.batch_axes`` must be the dp axes).
    """
    P = len(cfg.window_pattern)

    @torch.inference_mode()
    def prefill(model, tokens: torch.Tensor):
        rank = _rank_view(cfg, model, policy)
        b_all = tokens.shape[0]
        if rank is not None:
            if tuple(decode.batch_axes) != tuple(policy.dp_axes):
                raise ValueError(f"the prefill's batch shards over "
                                 f"{policy.dp_axes}, the cache's over "
                                 f"{decode.batch_axes}")
            tokens = rank.batch(tokens, policy.dp_axes)
        b, s = tokens.shape
        target = max_seq or s
        if target < s:
            raise ValueError(f"max_seq={target} is shorter than the prompt "
                             f"({s})")
        cache = init_cache(cfg, b_all, target, dtype=model.embed.dtype,
                           device=model.embed.device,
                           policy=policy, decode=decode)
        entries = [shape[2] for shape in cache_shapes(cfg, b, target)]
        blocks = [_seq_block(policy, decode, e)[:2] if rank is not None
                  else (0, e) for e in entries]

        def store(n: int, k: torch.Tensor, v: torch.Tensor) -> None:
            """Slots [lo, lo + n_slots) of the full-sequence entry: all of
            it on one device, the rank's block of it under a policy."""
            g, i = divmod(n, P)
            s_entry, (lo, n_slots) = entries[i], blocks[i]
            for name, t in (("k", k), ("v", v)):
                if rank is not None:
                    t = rank.full_kv(t)
                slots = cache[f"{name}{i}"][g]
                if s > s_entry:  # a windowed entry: the last s_entry, rolled
                    slots.copy_(torch.roll(t[:, s - s_entry:],
                                           shifts=(s - s_entry) % s_entry,
                                           dims=1)[:, lo:lo + n_slots])
                elif lo < s:
                    hi = min(lo + n_slots, s)
                    slots[:, :hi - lo] = t[:, lo:hi]

        x, _ = _prefill_layers(cfg, model, tokens, on_kv=store, rank=rank)
        if rank is None:
            return _logits(cfg, model, x[:, -1:])[:, 0], cache
        # The whole sequence, so that the last position is a view of it as
        # on one device (the same product, bit for bit at world size 1).
        x = rank.gather_seq(x)
        logits = rank.full_vocab(rank.logits(cfg, model, x[:, -1:]))[:, 0]
        return logits, cache

    return prefill


def _decode_attention_sharded(cfg: TransformerConfig, policy,
                              decode: DecodePolicy, q, k_cache, v_cache,
                              k_new, v_new, pos: int,
                              window: Optional[int]) -> torch.Tensor:
    """Decode attention over this rank's shard of the cache: write the new
    key and value where ``pos`` lands in the shard (in place), attend over
    the shard's valid slots, and combine the flash-decoding partials over
    the cache's sequence shards."""
    s_loc = k_cache.shape[1]
    n = policy.size(decode.cache_seq_axes) if decode.cache_seq_axes else 1
    s_entry = s_loc * n
    lo, _, group = _seq_block(policy, decode, s_entry)
    write = pos % s_entry if window is not None else pos
    if lo <= write < lo + s_loc:
        k_cache[:, write - lo] = k_new[:, 0]
        v_cache[:, write - lo] = v_new[:, 0]
    slots = lo + torch.arange(s_loc, device=q.device)
    valid = (slots <= pos) | (window is not None and pos >= s_entry)
    wv, m, z = attn_lib.decode_attention_partial(
        q, k_cache, v_cache,
        length_mask=valid[None].expand(q.shape[0], s_loc),
        attn_softcap=cfg.attn_softcap)
    return attn_lib.combine_decode_partials(wv, m, z, group).to(q.dtype)


def make_serve_step(cfg: TransformerConfig, max_seq: int, *, policy=None,
                    decode: DecodePolicy = DecodePolicy()):
    """Returns serve_step(model, cache, tokens (B, 1), pos) ->
    (logits (B, V), cache).

    One decode step: write the token's roped key and value at ``pos`` (the
    ring slot ``pos % window`` of a windowed entry) and attend over the
    valid slots.  MoE layers run every expert (the reference's decode).
    The cache is updated in place, where the reference returns an updated
    copy; the same dict is returned.

    Under ``policy`` every rank passes the same tokens, its
    :class:`ShardedTransformer` and its block of the cache (``decode``'s
    layout), and gets its batch slice (over ``decode.batch_axes``) of the
    logits, every column.  The residual is not sequence-sharded in a
    decode step: the row-parallel products end in an all-reduce, and the
    attention gathers the rank's query heads (tensor parallel) before it
    attends over the sequence shard.
    """
    P = len(cfg.window_pattern)

    @torch.inference_mode()
    def serve_step(model, cache: dict, tokens: torch.Tensor, pos: int):
        rank = _rank_view(cfg, model, policy)
        if rank is not None:
            tokens = rank.batch(tokens, decode.batch_axes)
            rank.sp = False
        b = tokens.shape[0]
        pos = int(pos)
        x = model.embed[tokens.long()] if rank is None else \
            rank.embed(model, tokens)
        dev = x.device
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        freqs = rope_freqs(cfg.d_head, theta=cfg.rope_theta, device=dev)
        for n, layer in enumerate(model.layers):
            g, i = divmod(n, P)
            window = layer.window
            kc, vc = cache[f"k{i}"][g], cache[f"v{i}"][g]
            if rank is not None:
                x = _sharded_decode_layer(cfg, rank, decode, layer, x,
                                          positions, freqs, kc, vc, pos)
                continue
            s_entry = min(window, max_seq) if window is not None else max_seq
            q, kn, vn = _qkv(cfg, layer, x, positions, freqs)
            write = pos % s_entry if window is not None else pos
            # In place: the reference returns an updated copy instead.
            kc[:, write] = kn[:, 0]
            vc[:, write] = vn[:, 0]
            slots = torch.arange(s_entry, device=dev)
            valid = (slots <= pos) | (window is not None and pos >= s_entry)
            out = attn_lib.decode_attention(
                q, kc, vc, length_mask=valid[None].expand(b, s_entry),
                attn_softcap=cfg.attn_softcap)
            x = x + out.reshape(b, 1, cfg.n_heads * cfg.d_head) @ layer.wo
            x, _ = _ffn(cfg, layer, x, decode=True)
        if rank is None:
            return _logits(cfg, model, x)[:, 0], cache
        return rank.full_vocab(rank.logits(cfg, model, x))[:, 0], cache

    return serve_step


def _sharded_decode_layer(cfg: TransformerConfig, rank: _RankView,
                          decode: DecodePolicy, layer, x, positions, freqs,
                          kc, vc, pos: int) -> torch.Tensor:
    """One layer of a decode step on one rank (the residual replicated
    over ``tp``): attention over the rank's cache shard, every query head,
    then the FFN (MoE: the rank's experts, every token), each
    row-parallel product summed over ``tp``."""
    b = x.shape[0]
    q, kn, vn = _project_qkv(cfg, layer, rms_norm(x, layer.ln1), positions,
                             freqs, rank.n_heads, rank.n_kv)
    q, kn, vn = (rank.full_kv(t) for t in (q, kn, vn))
    out = _decode_attention_sharded(cfg, rank.policy, decode, q, kc, vc, kn,
                                    vn, pos, layer.window)
    if rank.tp_heads:
        lo = rank.ti * rank.n_heads
        out = out[:, :, lo:lo + rank.n_heads]
    out = out.reshape(b, 1, rank.n_heads * cfg.d_head) @ layer.wo
    x = x + (rank.reduce_out(out) if rank.tp_heads else out)
    h = rms_norm(x, layer.ln2)
    if cfg.moe is None:
        return x + rank.reduce_out(swiglu(h, layer.w_gate, layer.w_up,
                                          layer.w_down))
    e_loc = cfg.moe.n_experts // rank.tp
    y, _ = moe_lib.moe_ffn_reference(
        layer.moe, h.reshape(b, cfg.d_model), cfg.moe,
        experts=slice(rank.ti * e_loc, (rank.ti + 1) * e_loc))
    y = y.reshape(b, 1, cfg.d_model)
    if cfg.moe.dense_residual_d_ff:
        y = y + swiglu(h, layer.res_gate, layer.res_up, layer.res_down)
    return x + rank.reduce_out(y)
