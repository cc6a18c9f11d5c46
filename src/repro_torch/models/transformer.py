"""Decoder-only transformer, served: prefill through kernel K5, then
greedy-ready decode steps over a KV cache.

The reference's ``models/transformer.py`` in PyTorch: dense configs
(SmolLM, granite, gemma2's local/global pattern with soft-caps) and MoE
configs with an optional dense residual branch (qwen3-moe, arctic).  Layers
are grouped by the repeating ``window_pattern`` as in the reference: layer
``g * P + i`` is group ``g``'s pattern entry ``i``, and each pattern entry
keeps its own KV cache ``(G, B, S_entry, Hk, d_head)``, where a windowed
entry holds a ring of ``window`` slots and a global one the whole sequence.

Prefill attention is ``kernels.ops.flash_attention`` on every layer (K5 on
CUDA tensors, its plain version on CPU tensors); decode attention is plain
PyTorch (:mod:`.attention`).  An MoE layer runs the capacity dispatch
(:func:`.moe.moe_ffn_capacity`) over all ``B * S`` tokens of a prefill or
forward call, as the reference's ``_ffn_block`` does, and the all-expert
path (:func:`.moe.moe_ffn_reference`) in a decode step.  Every entry runs
under ``torch.inference_mode()``: K5 has no backward.  Training, the
expert-parallel dispatch and the sharded and context-parallel paths are not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..backend import resolve_device
from ..kernels import ops
from . import attention as attn_lib
from . import moe as moe_lib
from .common import apply_rope, rms_norm, rope_freqs, softcap, swiglu
from .moe import MoE, MoEConfig

__all__ = ["TransformerConfig", "DecoderLayer", "Transformer", "LAYER_KEYS",
           "RESIDUAL_KEYS", "layer_keys", "forward", "forward_hidden",
           "make_prefill_step", "make_serve_step", "cache_shapes",
           "init_cache"]

#: Per-layer weights of a dense config, in the reference's block-dict names
#: and (in, out) layout: ``x @ w``.
LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
              "w_down")
#: An MoE layer's dense residual branch (arctic), in place of the FFN.
RESIDUAL_KEYS = ("res_gate", "res_up", "res_down")


@dataclass(frozen=True)
class TransformerConfig:
    """One decoder-only architecture.  The reference's training-memory and
    chunked-attention knobs (``remat``, ``q_chunk``) have no field here:
    nothing in the port trains, and K5 takes no chunking."""

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


def _qkv(cfg: TransformerConfig, layer: DecoderLayer, x: torch.Tensor,
         positions: torch.Tensor, freqs: torch.Tensor):
    b, s, _ = x.shape
    h = rms_norm(x, layer.ln1)
    q = (h @ layer.wq).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (h @ layer.wk).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (h @ layer.wv).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return apply_rope(q, positions, freqs), apply_rope(k, positions, freqs), v


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


def _prefill_layers(cfg: TransformerConfig, model: Transformer,
                    tokens: torch.Tensor, on_kv=None,
                    on_aux=None) -> torch.Tensor:
    """The residual stream after every layer; ``on_kv(n, k, v)`` receives
    layer ``n``'s roped keys and values (B, S, Hk, d_head), and ``on_aux``
    each MoE layer's balance loss."""
    b, s = tokens.shape
    x = model.embed[tokens.long()]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    freqs = rope_freqs(cfg.d_head, theta=cfg.rope_theta, device=x.device)
    for n, layer in enumerate(model.layers):
        q, k, v = _qkv(cfg, layer, x, positions, freqs)
        out = ops.flash_attention(q, k, v, causal=True, window=layer.window,
                                  softcap=cfg.attn_softcap)
        x = x + out.reshape(b, s, cfg.n_heads * cfg.d_head) @ layer.wo
        x, aux = _ffn(cfg, layer, x)
        if on_kv is not None:
            on_kv(n, k, v)
        if on_aux is not None and aux is not None:
            on_aux(aux)
    return x


@torch.inference_mode()
def forward_hidden(cfg: TransformerConfig, model: Transformer,
                   tokens: torch.Tensor):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux_loss): the MoE
    balance loss summed over the layers in fp32, 0 for a dense config."""
    losses = []
    x = _prefill_layers(cfg, model, tokens, on_aux=losses.append)
    aux = sum(losses, torch.zeros((), dtype=torch.float32, device=x.device))
    return rms_norm(x, model.final_norm), aux


@torch.inference_mode()
def forward(cfg: TransformerConfig, model: Transformer,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  S must meet K5's block contract
    (S <= 128 or S % 128 == 0).  The reference returns the MoE balance loss
    beside the logits; here :func:`forward_hidden` does."""
    return _logits(cfg, model, _prefill_layers(cfg, model, tokens))


def cache_shapes(cfg: TransformerConfig, batch: int,
                 max_seq: int) -> list[tuple]:
    """Per-pattern-entry cache shapes (G, B, S_entry, Hk, d_head)."""
    return [(cfg.n_groups, batch,
             min(window, max_seq) if window is not None else max_seq,
             cfg.n_kv_heads, cfg.d_head) for window in cfg.window_pattern]


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
               dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Zeroed caches ``{"k{i}", "v{i}"}`` per pattern entry ``i``, in the
    compute dtype, on CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    cache = {}
    for i, shape in enumerate(cache_shapes(cfg, batch, max_seq)):
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def make_prefill_step(cfg: TransformerConfig, *,
                      max_seq: Optional[int] = None):
    """Returns prefill(model, tokens (B, S)) -> (last logits (B, V), cache).

    One inference prefill: the forward pass plus the KV cache, sized for
    ``max_seq`` positions (default S) so decode continues at pos = S.  A
    windowed entry keeps the last ``window`` positions in ring layout (slot
    ``p % window`` holds position p); a longer entry is zero past S.
    """
    P = len(cfg.window_pattern)

    @torch.inference_mode()
    def prefill(model: Transformer, tokens: torch.Tensor):
        b, s = tokens.shape
        target = max_seq or s
        if target < s:
            raise ValueError(f"max_seq={target} is shorter than the prompt "
                             f"({s})")
        cache = init_cache(cfg, b, target, dtype=model.embed.dtype,
                           device=model.embed.device)

        def store(n: int, k: torch.Tensor, v: torch.Tensor) -> None:
            g, i = divmod(n, P)
            for name, t in (("k", k), ("v", v)):
                slots = cache[f"{name}{i}"][g]
                s_entry = slots.shape[1]
                if s > s_entry:  # a windowed entry: the last s_entry, rolled
                    slots.copy_(torch.roll(t[:, s - s_entry:],
                                           shifts=(s - s_entry) % s_entry,
                                           dims=1))
                else:
                    slots[:, :s] = t

        x = _prefill_layers(cfg, model, tokens, on_kv=store)
        return _logits(cfg, model, x[:, -1:])[:, 0], cache

    return prefill


def make_serve_step(cfg: TransformerConfig, max_seq: int):
    """Returns serve_step(model, cache, tokens (B, 1), pos) ->
    (logits (B, V), cache).

    One decode step: write the token's roped key and value at ``pos`` (the
    ring slot ``pos % window`` of a windowed entry) and attend over the
    valid slots.  MoE layers run every expert (the reference's decode).  The cache is updated in place, where the reference
    returns an updated copy; the same dict is returned.
    """
    P = len(cfg.window_pattern)

    @torch.inference_mode()
    def serve_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                   pos: int):
        b = tokens.shape[0]
        pos = int(pos)
        x = model.embed[tokens.long()]
        dev = x.device
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        freqs = rope_freqs(cfg.d_head, theta=cfg.rope_theta, device=dev)
        for n, layer in enumerate(model.layers):
            g, i = divmod(n, P)
            window = layer.window
            s_entry = min(window, max_seq) if window is not None else max_seq
            q, kn, vn = _qkv(cfg, layer, x, positions, freqs)
            write = pos % s_entry if window is not None else pos
            kc, vc = cache[f"k{i}"][g], cache[f"v{i}"][g]
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
        return _logits(cfg, model, x)[:, 0], cache

    return serve_step
