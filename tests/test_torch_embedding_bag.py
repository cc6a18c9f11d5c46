"""The port's embedding-bag kernel K6 against the JAX reference kernel.

The same numpy inputs, made from a seed, go through the reference
``ops.embedding_bag`` (Pallas in interpret mode, as the reference's own
tests run it) and the port's ``ops.embedding_bag`` on CPU tensors, which
takes the plain version there.  Both add a bag's rows in order into zeros
in the table's dtype, so they are held bit for bit, in f32 and in bf16.
Against take-then-sum (``embedding_bag_ref``) the tolerance is the
reference test's, 1e-6 relative in f32: the same sums in another order.
On the card the ``gpu``-marked tests hold the CUDA kernel against its plain
version, bit for bit; here they skip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops, ref

#: The reference's embedding-bag grid (v, d, b, hot).
GRID = [(128, 64, 8, 1), (1000, 128, 32, 4), (4096, 256, 16, 8)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _inputs(v, d, b, hot, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((v, d)).astype(np.float32),
            rng.integers(0, v, (b, hot)).astype(np.int32))


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Port ops vs reference ops, on the CPU.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,d,b,hot", GRID)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embedding_bag_bit_identical_to_reference_kernel(v, d, b, hot, dtype):
    jdt, tdt = DTYPES[dtype]
    tab, idx = _inputs(v, d, b, hot, v + hot)
    expect = jops.embedding_bag(jnp.asarray(tab, jdt), jnp.asarray(idx))
    got = ops.embedding_bag(torch.from_numpy(tab).to(tdt),
                            torch.from_numpy(idx))
    assert got.dtype == tdt and got.shape == (b, d)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(expect))


@pytest.mark.parametrize("v,d,b,hot", GRID)
def test_embedding_bag_matches_reference_take_then_sum(v, d, b, hot):
    tab, idx = _inputs(v, d, b, hot, 3 * v)
    expect = jref.embedding_bag_ref(jnp.asarray(tab), jnp.asarray(idx))
    got = ops.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx))
    assert _rel(got.numpy(), expect) < 1e-6
    port_ref = ref.embedding_bag_ref(torch.from_numpy(tab),
                                     torch.from_numpy(idx))
    assert _rel(port_ref.numpy(), expect) < 1e-6


def test_bf16_take_then_sum_rounds_otherwise():
    """Why the kernel is held to the sequential sum and not to
    take-then-sum in bf16: at hot 40 the two round differently."""
    tab, idx = _inputs(1000, 128, 32, 40, 5)
    t = torch.from_numpy(tab).to(torch.bfloat16)
    i = torch.from_numpy(idx)
    assert not torch.equal(eb.embedding_bag_plain(t, i),
                           ref.embedding_bag_ref(t, i))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_embedding_bag_permutation_invariant(seed):
    """Property: sum-pooling is invariant to bag order (the reference
    test's tolerance, 1e-5)."""
    rng = np.random.default_rng(seed)
    v, d, b, hot = 64, 32, 4, 6
    tab = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    idx = rng.integers(0, v, (b, hot)).astype(np.int32)
    perm = rng.permutation(hot)
    o1 = ops.embedding_bag(tab, torch.from_numpy(idx))
    o2 = ops.embedding_bag(tab, torch.from_numpy(np.ascontiguousarray(
        idx[:, perm])))
    assert _rel(o1.numpy(), o2.numpy()) < 1e-5


def test_strided_ids_and_output_slots():
    """A table's slice of (B, 26, hot) ids, written into its slot of a
    (B, 27, D) buffer, as the DLRM forward calls it."""
    rng = np.random.default_rng(8)
    tab = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    sparse = torch.from_numpy(rng.integers(0, 50, (6, 26, 3)).astype(
        np.int32))
    feats = torch.zeros(6, 27, 16)
    out = ops.embedding_bag(tab, sparse[:, 4, :], out=feats[:, 5])
    assert out.data_ptr() == feats[:, 5].data_ptr()
    expect = ref.embedding_bag_ref(tab, sparse[:, 4, :].contiguous())
    torch.testing.assert_close(feats[:, 5], expect, rtol=1e-6, atol=0)
    assert not feats[:, :5].any() and not feats[:, 6:].any()


# ---------------------------------------------------------------------------
# Geometry and the wrapper's contract.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,d,itemsize,aligned,expect", [
    (512, 128, 4, True, (4, 32, 8, 64)),
    (262144, 128, 4, True, (4, 32, 8, 32768)),
    (512, 128, 2, True, (8, 16, 8, 64)),
    (262144, 128, 2, True, (8, 16, 8, 32768)),
    (33, 100, 2, True, (1, 32, 8, 5)),
    (33, 100, 4, True, (4, 25, 8, 5)),
    (7, 30, 4, True, (1, 30, 8, 1)),
    (8, 128, 4, False, (1, 32, 8, 1)),
], ids=["p99-f32", "bulk-f32", "p99-bf16", "bulk-bf16", "d100-bf16",
        "d100-f32", "d30", "unaligned"])
def test_geometry(b, d, itemsize, aligned, expect):
    geo = eb.bag_geometry(b, d, itemsize, aligned=aligned)
    assert (geo.vec, geo.lanes_per_row, geo.bags_per_block,
            geo.grid) == expect
    assert geo.grid * geo.bags_per_block >= b > (geo.grid - 1) * \
        geo.bags_per_block


def _bad_calls():
    tab = torch.zeros(10, 8)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    return {
        "hot-0": (tab, torch.zeros(4, 0, dtype=torch.int32), {}),
        "int64-ids": (tab, ids.long(), {}),
        "float-ids": (tab, ids.float(), {}),
        "f64-table": (tab.double(), ids, {}),
        "f16-table": (tab.half(), ids, {}),
        "1d-ids": (tab, ids[:, 0], {}),
        "empty-batch": (tab, ids[:0], {}),
        "non-contiguous-table": (tab.t(), ids, {}),
        "wrong-out": (tab, ids, {"out": torch.zeros(4, 7)}),
        "out-dtype": (tab, ids, {"out": torch.zeros(4, 8,
                                                    dtype=torch.bfloat16)}),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_refuses(case):
    tab, ids, kw = _bad_calls()[case]
    with pytest.raises(ValueError):
        ops.embedding_bag(tab, ids, **kw)


def test_wrapper_raises_when_grad_is_needed():
    tab = torch.zeros(10, 8, requires_grad=True)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="backward"):
        ops.embedding_bag(tab, ids)
    with torch.inference_mode():
        assert ops.embedding_bag(tab, ids).shape == (4, 8)


@pytest.mark.parametrize("bad", [-1, 10])
def test_plain_version_raises_on_an_id_out_of_range(bad):
    ids = torch.tensor([[0, bad]], dtype=torch.int32)
    with pytest.raises(IndexError):
        ops.embedding_bag(torch.zeros(10, 8), ids)


def test_kernel_entry_point_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        eb.embedding_bag(torch.zeros(10, 8),
                         torch.zeros(4, 2, dtype=torch.int32))


def test_cpu_call_does_not_count_a_launch():
    ops.reset_launches()
    ops.embedding_bag(torch.zeros(10, 8), torch.zeros(4, 2,
                                                      dtype=torch.int32))
    assert ops.LAUNCHES["embedding_bag"] == 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("v,d,b,hot", GRID + [(1000, 100, 32, 4),
                                              (777, 30, 16, 3),
                                              (5000, 128, 64, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_bit_identical_to_plain_on_card(cuda_device, v, d, b, hot,
                                               dtype):
    tab, idx = _inputs(v, d, b, hot, d + hot)
    t = torch.from_numpy(tab).to(cuda_device, DTYPES[dtype][1])
    i = torch.from_numpy(idx).to(cuda_device)
    ops.reset_launches()
    got = ops.embedding_bag(t, i)
    assert ops.LAUNCHES["embedding_bag"] == 1
    assert torch.equal(got, eb.embedding_bag_plain(t, i))


@pytest.mark.gpu
def test_kernel_strided_slots_on_card(cuda_device):
    rng = np.random.default_rng(2)
    tab = torch.from_numpy(rng.standard_normal((300, 128)).astype(
        np.float32)).to(cuda_device)
    sparse = torch.from_numpy(rng.integers(0, 300, (40, 26, 2)).astype(
        np.int32)).to(cuda_device)
    feats = torch.zeros(40, 27, 128, device=cuda_device)
    for t in range(26):
        ops.embedding_bag(tab, sparse[:, t, :], out=feats[:, t + 1])
    for t in range(26):
        assert torch.equal(feats[:, t + 1],
                           eb.embedding_bag_plain(tab, sparse[:, t, :]))
    assert not feats[:, 0].any()
