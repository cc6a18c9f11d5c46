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
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain_version(b, s, h, hk, d, causal, window,
                                           cap, dtype, cuda_device):
    _, (q, k, v), tol = _both(_qkv(b, s, h, hk, d, s + d), dtype)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap, block_q=min(s, 64),
                              block_k=min(s, 64))
    expect = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      softcap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert _rel(_np(got.cpu()), _np(expect.cpu())) < tol
    if dtype == "bf16":
        # Both round fp32 results that agree to the f32 tolerance once to
        # bf16, so each element is at most one bf16 step (2^-7 relative)
        # from the plain version's, plus the f32 tolerance.
        diff = (got.float() - expect.float()).abs()
        allowed = (2.0 ** -7 * expect.float().abs()
                   + DTYPES["f32"][2] * float(expect.float().abs().max()))
        assert bool((diff <= allowed).all())
