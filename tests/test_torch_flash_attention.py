"""The port's attention kernel K5 against the JAX reference kernel.

The same numpy inputs, made from a seed, go through the reference
``ops.flash_attention`` (Pallas in interpret mode, as the reference's own
tests run it) and the port's ``ops.flash_attention`` on CPU tensors, which
takes the plain version there.  On the card the ``gpu``-marked test holds
the CUDA kernel against its plain version, in bf16 also element by element;
here it skips.  The kernel's tile skipping (windowed and non-causal cases)
is held only there, since the CUDA file alone decides which tiles a CTA
walks.

Tolerances are the reference's (``tests/test_kernels.py``), relative to the
largest output magnitude: 2e-5 for f32 (fp32 sums and exponentials in
another order) and 3e-2 for bf16 (one bf16 rounding of the output).

The bf16 CUDA kernel's arithmetic (tensor-core products, the online softmax
in the log2 domain, p split into two bf16 terms for p·v) is emulated here on
the CPU and held to the plain version at the element gate, so the numerics
of its design are tested where its code cannot run.  So is the f32 kernel's
(3xTF32: every operand split into TF32 hi and lo terms, three products a
product), held to the f32 tolerance, and one TF32 term shown to miss it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

#: The reference's flash-attention grid (s, d, block_q, block_k, window).
GRID = [
    (128, 64, 64, 64, None),
    (256, 64, 128, 64, None),
    (256, 32, 64, 128, 64),
    (512, 128, 128, 128, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


def _qkv(b, s, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)),
            rng.standard_normal((b, s, hk, d)),
            rng.standard_normal((b, s, hk, d)))


def _both(arrays, key):
    jdt, tdt, tol = DTYPES[key]
    j = [jnp.asarray(v, jdt) for v in arrays]
    t = [torch.as_tensor(np.asarray(v, np.float32)).to(tdt) for v in arrays]
    return j, t, tol


def _compare(arrays, key, **kw):
    (jq, jk, jv), (tq, tk, tv), tol = _both(arrays, key)
    expect = jops.flash_attention(jq, jk, jv, **kw)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _rel(_np(got), _np(expect)) < tol


#: One bf16 step relative to the value: 7 stored significand bits.
BF16_STEP = 2.0 ** -7


def _beyond_bf16_step(got, expect) -> int:
    """Elements of a bf16 ``got`` farther from the bf16 ``expect`` than one
    bf16 step of the value plus the f32 tolerance of the largest output: two
    fp32 results that agree to the f32 tolerance, each rounded once to bf16,
    are never farther apart."""
    diff = (got.float() - expect.float()).abs()
    allowed = (BF16_STEP * expect.float().abs()
               + DTYPES["f32"][2] * float(expect.float().abs().max()))
    return int((~(diff <= allowed)).sum())


def _kernel_arithmetic(q, k, v, *, causal=True, window=None, softcap=None,
                       kv_tile=64, split=True):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch, tile by tile.

    Products of bf16 values are exact, so q·k is summed in fp64 and rounded
    to fp32 as the tensor cores' fp32 sum nearly is; then the scale (or the
    softcap), the mask to -inf, the running max in the log2 domain from
    -1e30, ``corr = exp2(m_prev - m_new)``, fp32 weights p and their fp32
    row sum l.  For p·v, p is split into ``hi`` (p with its low 16 bits
    cleared) and ``lo = bf16(p - hi)``, or with ``split=False`` rounded once
    to bf16; each term's products with v are exact and their fp64 sum is
    added to the fp32 accumulator.  ``kv_tile`` is the kernel's: 64 rows at
    D = 64 and D = 256."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    qd = q.double().transpose(1, 2)
    kd = k.repeat_interleave(rep, 2).double().transpose(1, 2)
    vd = v.repeat_interleave(rep, 2).double().transpose(1, 2)
    scale, log2e = d ** -0.5, 1.4426950408889634
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for c0 in range(0, s, kv_tile):
        cols = torch.arange(c0, min(c0 + kv_tile, s))[None, :]
        sc = (qd @ kd[:, :, c0:c0 + kv_tile].transpose(-1, -2)).float()
        mul = scale * log2e
        if softcap is not None:
            sc = (softcap * log2e) * torch.tanh(sc * (scale / softcap))
            mul = 1.0
        keep = torch.ones((s, cols.shape[1]), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= rows - cols < window
        sc = sc.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1) * mul)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc * mul - m_new[..., None])
        l = l * corr + p.sum(-1)
        if split:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            terms = (hi, (p - hi).bfloat16())
        else:
            terms = (p.bfloat16(),)
        vt = vd[:, :, c0:c0 + kv_tile]
        acc = (acc * corr[..., None]
               + sum(t.double() @ vt for t in terms).float())
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).bfloat16()


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 stored significand bits, to
    nearest with ties away from zero, by bit arithmetic on the int32 view
    (adding half of the dropped 13 bits' unit to the magnitude, then
    clearing them)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_terms(x, split):
    """x as TF32 terms: hi = tf32(x) and lo = tf32(x - hi), or tf32(x)."""
    hi = _tf32(x)
    return (hi, _tf32(x - hi)) if split else (hi,)


def _tf32_product(a, b, split):
    """a @ b as the kernel's wgmma sums it: hi.hi + lo.hi + hi.lo (or one
    TF32 term), each product exact, summed in fp64 and rounded to fp32."""
    if not split:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    (ah, al), (bh, bl) = _tf32_terms(a, True), _tf32_terms(b, True)
    return (ah.double() @ bh.double() + al.double() @ bh.double()
            + ah.double() @ bl.double()).float()


#: A tile's kv order in the f32 kernel's V^T: within each group of 8, kv
#: 2t at slot t and 2t + 1 at slot t + 4.
def _kv_slots(n):
    r = torch.arange(n)
    return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)


def _tf32_kernel_arithmetic(q, k, v, *, causal=True, window=None,
                            softcap=None, split=True):
    """The f32 CUDA kernel's arithmetic in plain PyTorch, tile by tile.

    q is scaled by D^-1/2 in fp32, then q, k, the fp32 weights p and v are
    each split into TF32 hi and lo terms (``split=False``: rounded once to
    TF32); each product is summed as :func:`_tf32_product` does, per kv
    tile of the kernel's size (64 rows up to D = 64, 32 above).  p and v
    take the kernel's kv order within the tile (:func:`_kv_slots`).  The
    softcap, the mask to -inf, the online softmax in the log2 domain from
    -1e30 and the fp32 row sums are the bf16 emulation's."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kv_tile = 64 if d <= 64 else 32
    qs = (q * d ** -0.5).transpose(1, 2)
    kd = k.repeat_interleave(rep, 2).transpose(1, 2)
    vd = v.repeat_interleave(rep, 2).transpose(1, 2)
    log2e = 1.4426950408889634
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for c0 in range(0, s, kv_tile):
        n = min(kv_tile, s - c0)
        cols = torch.arange(c0, c0 + n)[None, :]
        sc = _tf32_product(qs, kd[:, :, c0:c0 + n].transpose(-1, -2), split)
        mul = log2e
        if softcap is not None:
            sc = (softcap * log2e) * torch.tanh(sc * (1.0 / softcap))
            mul = 1.0
        keep = torch.ones((s, n), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= rows - cols < window
        sc = sc.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1) * mul)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc * mul - m_new[..., None])
        l = l * corr + p.sum(-1)
        order = torch.argsort(_kv_slots(n))  # the kv row at each slot
        acc = (acc * corr[..., None]
               + _tf32_product(p[..., order], vd[:, :, c0 + order], split))
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)


def _bf16_qkv(b, s, h, hk, d, seed):
    return [torch.as_tensor(np.asarray(a, np.float32)).bfloat16()
            for a in _qkv(b, s, h, hk, d, seed)]


@pytest.fixture
def one_thread():
    """The emulations' products are small: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Port ops vs reference ops, on the CPU.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,d,bq,bk,window", GRID)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_reference(s, d, bq, bk, window, dtype):
    _compare(_qkv(2, s, 2, 2, d, s + d), dtype, window=window, block_q=bq,
             block_k=bk)


@pytest.mark.parametrize("h,hk,d", [(8, 2, 32), (9, 3, 64)],
                         ids=["rep4", "rep3-smollm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_gqa_matches_reference(h, hk, d, dtype):
    _compare(_qkv(2, 128, h, hk, d, h), dtype, block_q=64, block_k=64)


@pytest.mark.parametrize("cap", [8.0, 50.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_softcap_matches_reference(cap, dtype):
    _compare(_qkv(1, 128, 2, 2, 32, 7), dtype, softcap=cap, block_q=64,
             block_k=64)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_leading_kv_blocks_fully_masked_under_a_window(dtype):
    """Window 32 at s = 256: the rows of q block 3 see nothing of kv blocks
    0-1, so their running max stays -1e30 (corr = 1) until block 2."""
    _compare(_qkv(2, 256, 2, 1, 64, 3), dtype, window=32, softcap=50.0,
             block_q=64, block_k=64)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_non_causal_matches_reference(window):
    _compare(_qkv(2, 128, 4, 2, 32, 9), "f32", causal=False, window=window,
             block_q=64, block_k=64)


@pytest.mark.parametrize("s", [16, 48, 96])
def test_flash_attention_short_sequences(s):
    """s < 128: both blocks clamp to s."""
    _compare(_qkv(2, s, 3, 1, 16, s), "f32")


def test_softcap_oracle_matches_reference_inline_oracle():
    """The port's ``flash_attention_ref`` with a softcap against the oracle
    the reference test builds inline (tests/test_kernels.py:114-126)."""
    q, k, v = _qkv(1, 128, 2, 2, 32, 11)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    scores = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * 32 ** -0.5
    scores = 8.0 * jnp.tanh(scores / 8.0)
    mask = jnp.tril(jnp.ones((128, 128), bool))
    scores = jnp.where(mask[None, None], scores, -1e30)
    expect = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(scores, -1), jv)
    got = ref.flash_attention_ref(*(torch.as_tensor(a, dtype=torch.float32)
                                    for a in (q, k, v)), softcap=8.0)
    assert _rel(_np(got), _np(expect)) < 2e-5


@pytest.mark.parametrize("window", [None, 64])
def test_oracle_matches_reference_oracle(window):
    arrays = _qkv(2, 256, 2, 2, 32, 5)
    expect = jref.flash_attention_ref(*(jnp.asarray(a, jnp.float32)
                                        for a in arrays), window=window)
    got = ref.flash_attention_ref(*(torch.as_tensor(a, dtype=torch.float32)
                                    for a in arrays), window=window)
    assert _rel(_np(got), _np(expect)) < 2e-5


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_rows_are_convex_combinations(seed):
    """Each output row lies in the convex hull of V's rows."""
    q, k, v = (torch.as_tensor(a, dtype=torch.float32)
               for a in _qkv(1, 128, 1, 1, 16, seed))
    out = ops.flash_attention(q, k, v, block_q=64, block_k=64)
    assert float(out.max()) <= float(v.max()) + 1e-4
    assert float(out.min()) >= float(v.min()) - 1e-4


# ---------------------------------------------------------------------------
# The bf16 kernel's numerics, emulated on the CPU.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [{}, {"softcap": 50.0},
                                  {"window": 100}],
                         ids=["causal", "softcap50", "window100"])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s", [128, 512])
def test_split_p_arithmetic_holds_the_element_gate(s, d, case, one_thread):
    """hi + lo bf16 terms of p: within 3e-2 of the plain version and every
    element within one bf16 step of it, GQA at rep 2."""
    q, k, v = _bf16_qkv(2, s, 4, 2, d, s + d)
    expect = fa.flash_attention_plain(q, k, v, **case)
    got = _kernel_arithmetic(q, k, v, **case)
    assert got.shape == expect.shape and got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(expect)) < DTYPES["bf16"][2]
    assert _beyond_bf16_step(got, expect) == 0


def test_one_term_bf16_p_breaks_the_element_gate(one_thread):
    """Why the kernel splits p: rounded once to bf16 for p·v, as
    FlashAttention-2 and -3 do, it moves thousands of elements farther than
    one bf16 step from the plain version at S = 512, D = 64."""
    q, k, v = _bf16_qkv(2, 512, 4, 2, 64, 576)
    expect = fa.flash_attention_plain(q, k, v)
    assert _beyond_bf16_step(_kernel_arithmetic(q, k, v), expect) == 0
    assert _beyond_bf16_step(_kernel_arithmetic(q, k, v, split=False),
                             expect) > 1000


# ---------------------------------------------------------------------------
# The f32 kernel's numerics (3xTF32), emulated on the CPU.
# ---------------------------------------------------------------------------
def _f32_qkv(b, s, h, hk, d, seed):
    return [torch.as_tensor(np.asarray(a, np.float32))
            for a in _qkv(b, s, h, hk, d, seed)]


@pytest.mark.parametrize("case", [{}, {"softcap": 50.0},
                                  {"window": 100}],
                         ids=["causal", "softcap50", "window100"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [128, 200, 512])
def test_tf32_split_arithmetic_holds_the_f32_tolerance(s, d, case,
                                                       one_thread):
    """hi + lo TF32 terms of q, k, p and v, three products a product:
    within 2e-5 of the plain version, GQA at rep 2, S = 200 ragged for
    either kv tile."""
    q, k, v = _f32_qkv(1, s, 2, 1, d, s + d)
    expect = fa.flash_attention_plain(q, k, v, **case)
    got = _tf32_kernel_arithmetic(q, k, v, **case)
    assert got.shape == expect.shape and got.dtype == torch.float32
    assert _rel(_np(got), _np(expect)) < DTYPES["f32"][2]


def test_kv_slots_put_accumulator_columns_in_fragment_slots():
    """The k8 A fragment wants k slots t and t + 4 where the accumulator
    holds kv columns 2t and 2t + 1: the slot of kv 2t is t, of 2t + 1 t + 4,
    in every group of 8."""
    slots = _kv_slots(64)
    for t in range(4):
        assert (slots[2 * t::8] == torch.arange(t, 64, 8)).all()
        assert (slots[2 * t + 1::8] == torch.arange(t + 4, 64, 8)).all()
    assert sorted(slots.tolist()) == list(range(64))


def test_one_tf32_term_misses_the_f32_tolerance(one_thread):
    """Why the kernel splits: each operand rounded once to TF32 (10 stored
    significand bits) moves the output by far more than 2e-5 at S = 512,
    D = 64, where the split stays inside it."""
    q, k, v = _f32_qkv(1, 512, 2, 1, 64, 576)
    expect = fa.flash_attention_plain(q, k, v)
    assert _rel(_np(_tf32_kernel_arithmetic(q, k, v)), _np(expect)) < 2e-5
    one = _rel(_np(_tf32_kernel_arithmetic(q, k, v, split=False)),
               _np(expect))
    assert one > 10 * DTYPES["f32"][2]


def test_tf32_rounding_is_to_nearest_ties_away():
    """``_tf32`` against exact cases: 1 + 2^-11 (a tie) rounds up to
    1 + 2^-10, and -(1 + 2^-11) to -(1 + 2^-10); 1 + 2^-12 rounds down;
    every result keeps 10 significand bits."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0])
    assert _tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0]
    r = _tf32(torch.randn(1000))
    assert not bool((r.view(torch.int32) & 0x1FFF).any())


# ---------------------------------------------------------------------------
# The contract: blocks, gradients, operands, devices, launches.
# ---------------------------------------------------------------------------
def test_block_contract_raises_like_the_reference():
    """s = 192 does not divide into 128-blocks: the reference asserts, the
    port raises."""
    arrays = _qkv(1, 192, 2, 2, 32, 0)
    (jq, jk, jv), (tq, tk, tv), _ = _both(arrays, "f32")
    with pytest.raises(AssertionError):
        jops.flash_attention(jq, jk, jv)
    with pytest.raises(ValueError, match="divide into"):
        ops.flash_attention(tq, tk, tv)
    ops.flash_attention(tq, tk, tv, block_q=64, block_k=64)


def test_requires_grad_raises():
    q, k, v = (torch.as_tensor(a, dtype=torch.float32)
               for a in _qkv(1, 64, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with torch.inference_mode():
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["heads", "dtype", "window", "layout"])
def test_operand_checks(bad):
    q, k, v = (torch.as_tensor(a, dtype=torch.float32)
               for a in _qkv(1, 64, 4, 2, 16, 0))
    if bad == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "dtype":
        q = q.half()
    elif bad == "layout":
        q = q[0]
    kw = {"window": 0} if bad == "window" else {}
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)


def test_kernel_refuses_cpu_tensors_and_odd_head_dims():
    q, k, v = (torch.as_tensor(a, dtype=torch.float32)
               for a in _qkv(1, 64, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    for d in (8, 24, 272):
        with pytest.raises(ValueError, match="head dim"):
            fa.check_head_dim(d)


@pytest.mark.parametrize("d", [16, 48, 64, 128, 256])
def test_kernel_takes_head_dims_that_are_multiples_of_16(d):
    """SmolLM's 64, gemma2's 256 and every multiple of 16 between."""
    fa.check_head_dim(d)


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    q, k, v = (torch.as_tensor(a, dtype=torch.float32)
               for a in _qkv(1, 64, 2, 2, 16, 0))
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hk,d,causal,window,cap", [
    (2, 128, 2, 2, 64, True, None, None), (2, 256, 2, 2, 32, True, 64, None),
    (1, 512, 2, 2, 128, True, 128, None), (2, 128, 9, 3, 64, True, None, None),
    (1, 128, 2, 2, 32, True, None, 50.0), (1, 96, 4, 1, 256, True, 40, 50.0),
    (2, 48, 3, 1, 16, True, None, None), (2, 128, 4, 2, 32, False, 40, None),
    (8, 1920, 9, 3, 64, True, None, None), (1, 300, 8, 4, 256, True, 128, 50.0),
    (2, 200, 9, 3, 64, True, None, None), (1, 256, 32, 4, 128, True, None, None),
    (1, 200, 8, 4, 256, True, None, 50.0),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain_version(b, s, h, hk, d, causal, window,
                                           cap, dtype, cuda_device):
    """The reference grid's edges, the serving shape (8, 1920, 9, 3, 64),
    gemma2's head dim with softcap 50 and a window, qwen3-moe's head (H 32,
    Hk 4, D 128), and S = 200, 300 that are not multiples of either
    kernel's q block (f32: 192 rows up to D = 64, 128 at D = 128, 64 at
    D = 256; bf16: 192 rows at D = 64, 128 above)."""
    _, (q, k, v), tol = _both(_qkv(b, s, h, hk, d, s + d), dtype)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    block = 64 if s % 64 == 0 else s  # blocks must divide s
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap, block_q=block, block_k=block)
    expect = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      softcap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert _rel(_np(got.cpu()), _np(expect.cpu())) < tol
    if dtype == "bf16":
        assert _beyond_bf16_step(got, expect) == 0
