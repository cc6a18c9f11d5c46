"""The training attention's K and V: what ``chunked_causal_attention``'s
per-chunk checkpoints keep, and that the values did not move.

The function once made layer-sized fp32 copies of the repeated K and V
before its chunk loop and read them, and ``q`` (for its device), by
closure from the checkpointed chunk; a non-reentrant checkpoint keeps its
function, closure and all, until the backward, so every layer's copies and
its Q outlived the decoder group's remat.  It now repeats K and V in their
own dtype, as the reference does, hands them to each chunk's checkpoint
as inputs and casts them to fp32 inside the chunk, and its closure holds
no tensor but the keys' positions.  ``_closure_attention`` below is the
earlier function, kept to compare with.

* The same operations run in the same order, so the LM loss and every
  gradient are bit for bit the earlier function's, on the CPU in fp32: the
  SmolLM smoke config, gemma2's (GQA, a sliding window, attention and final
  softcaps) and a GQA config with several query chunks, remat on and off;
  and the function alone at a context-parallel ``q_offset``.
* Under ``FakeTensorMode`` a small LM train step (remat on, four
  layers, several query chunks) traces with a peak lower by at least the
  fp32 repeated K and V of every layer, which the earlier function held
  across the forward; and nothing of Q, K and V outlives its layer:
  four more layers raise the peak by less than one layer's fp32 Q.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import params
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.launch.counters import StepCounter
from repro_torch.models import attention
from repro_torch.models import transformer as tr
from repro_torch.models.common import softcap
from repro_torch.tree import tree_leaves, tree_map, value_and_grad


def _closure_attention(q, k, v, *, window: Optional[int] = None,
                       attn_softcap: Optional[float] = None,
                       q_chunk: int = 1024, q_offset: int = 0,
                       score_budget_bytes: int = 1 << 29) -> torch.Tensor:
    """The earlier ``chunked_causal_attention``: fp32 copies of the
    repeated K and V made before the chunk loop and closed over."""
    b, s, h, d = q.shape
    s_kv = k.shape[1]
    n_rep = h // k.shape[2]
    scale = d ** -0.5
    q_chunk = min(q_chunk, s)
    per_row_bytes = b * h * s_kv * 4
    while (q_chunk > 16 and q_chunk * per_row_bytes > score_budget_bytes
           and s % (q_chunk // 2) == 0):
        q_chunk //= 2
    if s % q_chunk:
        q_chunk = s
    n_chunks = s // q_chunk
    kt = attention.repeat_kv(k, n_rep).permute(0, 2, 3, 1).float()
    vt = attention.repeat_kv(v, n_rep).permute(0, 2, 1, 3).float()
    qs = q.permute(0, 2, 1, 3).reshape(b, h, n_chunks, q_chunk, d)
    kv_pos = torch.arange(s_kv, device=q.device)

    def one_chunk(ci: int, qc: torch.Tensor) -> torch.Tensor:
        q_pos = (q_offset + ci * q_chunk
                 + torch.arange(q_chunk, device=q.device))
        scores = torch.einsum("bhqd,bhdk->bhqk", qc.float() * scale, kt)
        if attn_softcap is not None:
            scores = softcap(scores, attn_softcap)
        causal = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            causal &= (q_pos[:, None] - kv_pos[None, :]) < window
        scores = torch.where(causal, scores,
                             torch.tensor(-1e30, dtype=scores.dtype))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vt)

    out = torch.stack([checkpoint(one_chunk, ci, qs[:, :, ci],
                                  use_reentrant=False)
                       for ci in range(n_chunks)], dim=2)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)


#: (config, batch, seq): every one with more than one query chunk.
LM_CASES = {
    "smollm-smoke": (get_arch("smollm-135m").make_smoke_config(), 2, 64),
    "smollm-smoke-no-remat": (
        get_arch("smollm-135m").make_smoke_config(remat="none"), 2, 48),
    "gemma2-smoke": (get_arch("gemma2-2b").make_smoke_config(), 2, 48),
    "gqa-3": (tr.TransformerConfig(
        name="gqa-3", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_head=8, d_ff=64, vocab=128, dtype="float32", q_chunk=16), 3, 64),
}


def _loss_and_grads(cfg, b: int, s: int):
    tree = params.tensor_tree(params.transformer_params(cfg, seed=5),
                              device="cpu")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             synthetic.lm_batch(0, 1, batch=b, seq=s,
                                vocab=cfg.vocab).items()}
    (loss, _), grads = value_and_grad(lambda p, x: tr.loss_fn(cfg, p, x))(
        tree, batch)
    return loss, tree_leaves(grads)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_loss_and_grads_are_the_closure_functions_bit_for_bit(
        case, monkeypatch):
    cfg, b, s = LM_CASES[case]
    assert s > cfg.q_chunk
    loss, grads = _loss_and_grads(cfg, b, s)
    monkeypatch.setattr(attention, "chunked_causal_attention",
                        _closure_attention)
    want_loss, want_grads = _loss_and_grads(cfg, b, s)
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want_grads)
    for got, want in zip(grads, want_grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("window,cap", [(None, None), (24, 50.0)])
def test_context_parallel_offset_is_the_closure_functions(window, cap):
    """A rank's query shard at global offset 64 among 128 keys, GQA 4:1,
    four chunks: output and the gradients of q, k and v bit for bit."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_()
        for shape in ((2, 64, 8, 16), (2, 128, 2, 16), (2, 128, 2, 16)))
    ct = torch.from_numpy(rng.standard_normal((2, 64, 8, 16)).astype(
        np.float32))
    kw = dict(window=window, attn_softcap=cap, q_chunk=16, q_offset=64)
    outs = []
    for fn in (attention.chunked_causal_attention, _closure_attention):
        out = fn(q, k, v, **kw)
        outs.append((out, torch.autograd.grad((out * ct).sum(), (q, k, v))))
    (out, grads), (want, want_grads) = outs
    assert torch.equal(out, want)
    for got, w in zip(grads, want_grads):
        assert torch.equal(got, w)


#: A small LM whose repeated fp32 K and V are most of a train step's
#: activations: four layers, GQA 4:1, 512 tokens in 8 query chunks.
TRACE_CFG = tr.TransformerConfig(
    name="kv-trace", n_layers=4, d_model=32, n_heads=8, n_kv_heads=2,
    d_head=32, d_ff=64, vocab=64, dtype="float32", q_chunk=64)
TRACE_B, TRACE_S = 4, 512


def _traced_peak(fn, cfg=TRACE_CFG) -> int:
    """The peak live bytes of one loss-and-gradients call of ``cfg`` under
    ``FakeTensorMode``, over the bytes its arguments hold."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    old = attention.chunked_causal_attention
    attention.chunked_causal_attention = fn
    try:
        counter = StepCounter()
        with FakeTensorMode():
            tree = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                            tr.abstract_params(cfg))
            batch = {k: torch.zeros((TRACE_B, TRACE_S), dtype=torch.int32)
                     for k in ("tokens", "labels")}
            counter.hold((tree, batch))
            counter.reset_peak()
            base = counter.live
            with counter:
                (loss, _), grads = value_and_grad(
                    lambda p, x: tr.loss_fn(cfg, p, x))(tree, batch)
            del loss, grads
    finally:
        attention.chunked_causal_attention = old
    return counter.peak - base


def _kv_f32_bytes(cfg) -> int:
    """One layer's fp32 K and V repeated to the query heads."""
    return 2 * TRACE_B * TRACE_S * cfg.n_heads * cfg.d_head * 4


def test_traced_peak_falls_by_the_fp32_kv_copies():
    import dataclasses

    new = _traced_peak(attention.chunked_causal_attention)
    old = _traced_peak(_closure_attention)
    kv = _kv_f32_bytes(TRACE_CFG)
    print(f"traced peak: closure {old} B, inputs {new} B, fall {old - new} "
          f"B; fp32 K and V {kv} B a layer")
    assert old - new >= TRACE_CFG.n_layers * kv
    # Nothing of Q, K and V lives past its layer: four more layers add
    # less than one layer's fp32 Q (their inputs, weights and gradients).
    deep = dataclasses.replace(TRACE_CFG, n_layers=2 * TRACE_CFG.n_layers)
    grown = _traced_peak(attention.chunked_causal_attention, deep) - new
    assert grown < kv // 2, (grown, kv)
