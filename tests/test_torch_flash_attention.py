"""The port's attention kernel functions against the reference's (CPU).

The reference's ``ops.flash_attention(use_pallas=True)`` runs its Pallas
kernel in interpret mode here (below one 128-row block it takes its oracle);
the port's ``ops.flash_attention`` on a CPU tensor runs
``flash_attention_plain``, the plain version its CUDA kernel is held against
on the card. Inputs are drawn with numpy from a seed and handed to both.

Tolerances: f32, 2e-5 absolute and relative (the reference's own kernel
tests: the same f32 arithmetic, summed in another order); bf16, each side
rounds an f32 result to bf16 once, so two f32 values on either side of a
rounding boundary land one ulp apart: at most 2^-7 of the largest |out| in
their own row, and, since only such pairs differ, a relative RMS within
half an ulp, 2^-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7
BF16_RMS_TOL = 2.0 ** -8


def _qkv(seed, b, hq, hkv, sq, skv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, hd), (b, hkv, skv, hd),
                          (b, hkv, skv, hd))]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        diff = np.abs(got - want)
        assert (diff.max(-1) <= BF16_TOL * np.abs(want).max(-1)).all()
        assert np.sqrt(np.square(diff).sum()) <= BF16_RMS_TOL * np.sqrt(
            np.square(want).sum())
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _both(arrays, dtype, **kw):
    want = jops.flash_attention(*_jax(arrays, dtype), use_pallas=True, **kw)
    got = tops.flash_attention(*_torch(arrays, dtype), **kw)
    return got, want


@pytest.mark.parametrize("window", [32, 64, 128])
def test_sliding_window_matches_reference_kernel(window):
    arrays = _qkv(0, 1, 2, 2, 256, 256, 32)
    got, want = _both(arrays, "float32", causal=True, window=window)
    _assert_close(got, want, "float32")


def test_cross_lengths_match_reference_kernel():
    """Decode-style: sq < skv, positions aligned at the end."""
    arrays = _qkv(1, 1, 2, 2, 128, 384, 32)
    got, want = _both(arrays, "float32", causal=True)
    _assert_close(got, want, "float32")


def test_small_case_matches_reference():
    """Below one block the reference takes its oracle; the port's plain
    version needs no block at all."""
    arrays = _qkv(2, 1, 2, 2, 17, 17, 16)
    got, want = _both(arrays, "float32", causal=True)
    _assert_close(got, want, "float32")


def test_rows_sum_to_one():
    """Attention over constant V returns that constant (the softmax weights
    sum to one), in both packages."""
    q, k, _ = _qkv(3, 1, 2, 2, 256, 256, 32)
    v = np.ones_like(k)
    got, want = _both([q, k, v], "float32", causal=True)
    _assert_close(got, want, "float32")
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(b=2, hq=4, hkv=2, sq=256, skv=256),          # GQA
    dict(b=1, hq=4, hkv=2, sq=200, skv=200),          # ragged: padded to 256
    dict(b=1, hq=2, hkv=1, sq=128, skv=300),          # ragged key stream
])
def test_gqa_and_ragged_match_reference_kernel(case, dtype):
    arrays = _qkv(4, hd=32, **case)
    got, want = _both(arrays, dtype, causal=True)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100])
def test_head_dim_256_matches_reference_kernel(window, dtype):
    """recurrentgemma-2b's and paligemma-3b's head dim, with their one kv
    head: 2 query heads on 1, causal, with and without a window."""
    arrays = _qkv(8, 1, 2, 1, 256, 256, 256)
    got, want = _both(arrays, dtype, causal=True, window=window)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 48])
def test_oracle_matches_reference_oracle(window):
    """The port's softmax oracle against the reference's, expanded heads."""
    arrays = _qkv(5, 2, 3, 3, 96, 160, 16)
    want = jref.flash_attention_ref(*_jax(arrays, "float32"), causal=True,
                                    window=window)
    got = tref.flash_attention_ref(*_torch(arrays, "float32"), causal=True,
                                   window=window)
    _assert_close(got, want, "float32")


def test_plain_emits_zeros_on_fully_masked_rows():
    """Rows that see no key give zeros, as the Pallas kernel's l == 0 -> 1
    does; the oracle gives NaN there."""
    q, k, v = _torch(_qkv(6, 1, 2, 2, 8, 5, 16), "float32")
    # sq > skv: rows 0-2 sit before the first key (q_offset = -3)
    out = tops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    assert bool((out[:, :, 3:].abs().sum(-1) > 0).all())
    oracle = tref.flash_attention_ref(q, k, v, causal=True)
    assert bool(torch.isnan(oracle[:, :, :3]).all())
    torch.testing.assert_close(out[:, :, 3:], oracle[:, :, 3:], rtol=F32_TOL,
                               atol=F32_TOL)
    none = tref.flash_attention_plain(q, k, v, causal=True, kv_valid=0)
    assert torch.equal(none, torch.zeros_like(none))


def test_plain_masks_match_the_reference_kernel_arguments():
    """q_offset and kv_valid, as the reference's wrapper passes them to its
    kernel when it pads both streams."""
    import repro.kernels.flash_attention as jfa
    arrays = _qkv(7, 1, 2, 2, 128, 256, 32)
    kw = dict(causal=True, window=100, q_offset=96, kv_valid=224)
    want = jfa.flash_attention_pallas(*_jax(arrays, "float32"),
                                      interpret=True, **kw)
    got = tref.flash_attention_plain(*_torch(arrays, "float32"), **kw)
    _assert_close(got, want, "float32")


@settings(max_examples=4, deadline=None)
@given(
    b=st.integers(1, 2),
    hq=st.sampled_from([2, 4]),
    gqa=st.sampled_from([1, 2]),
    sq=st.sampled_from([128, 256, 300]),
    hd=st.sampled_from([32, 64]),
    dtype=st.sampled_from(["float32", "bfloat16"]),
    seed=st.integers(0, 100),
)
def test_flash_attention_matches_reference_property(b, hq, gqa, sq, hd, dtype,
                                                     seed):
    arrays = _qkv(seed, b, hq, hq // gqa, sq, sq, hd)
    got, want = _both(arrays, dtype, causal=True)
    _assert_close(got, want, dtype)


# the CUDA wrapper's host-side choices (the kernels themselves run only on
# the card: tests/test_torch_gpu.py)
def test_route_is_chosen_by_dtype_alone():
    from repro_torch.kernels import flash_attention as tfa
    assert tfa.route(torch.bfloat16) == "tc_bf16"
    assert tfa.route(torch.float32) == "simt_f32"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.route(torch.float16)
    assert set(tfa.ROUTE_LAUNCHES) == {"tc_bf16", "simt_f32"}


@pytest.mark.parametrize("hd,padded", [(16, 64), (32, 64), (64, 64),
                                       (80, 128), (128, 128), (256, 256)])
def test_tensor_core_kernel_pads_head_dims_to_its_boxes(hd, padded):
    """Every head dim the kernels take runs on the tensor cores, in tiles of
    64-column boxes: at most one box of zeros past hd."""
    from repro_torch.kernels import flash_attention as tfa
    assert hd in tfa.HEAD_DIMS
    assert tfa.padded_head_dim(hd) == padded
    assert padded % 64 == 0 and 0 <= padded - hd < 64


@pytest.mark.parametrize("hd", [8, 48, 96, 512])
def test_padded_head_dim_refuses_what_no_kernel_takes(hd):
    from repro_torch.kernels import flash_attention as tfa
    with pytest.raises(ValueError, match="head dims"):
        tfa.padded_head_dim(hd)


def test_reset_launches_zeroes_the_route_counts():
    from repro_torch.kernels import flash_attention as tfa
    tfa.ROUTE_LAUNCHES["tc_bf16"] += 3
    tops.LAUNCHES["flash_attention"] += 3
    tops.reset_launches()
    assert tfa.ROUTE_LAUNCHES == {"tc_bf16": 0, "simt_f32": 0}
    assert tops.LAUNCHES["flash_attention"] == 0


# (hq, hkv given, group, q_head0): a model rank's query heads that straddle
# GQA groups (qwen2-7b's 28 / 4 heads over a model axis of 8: rank 1's
# heads 4-7 read kv heads 0 and 1), an MQA block starting mid-group, and a
# launch whose first head is not a multiple of its group
HEAD_OFFSETS = [(4, 2, 7, 4), (3, 1, 10, 5), (5, 3, 2, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,group,q_head0", HEAD_OFFSETS)
def test_head_offset_reads_the_kv_heads_of_the_model(hq, hkv, group, q_head0,
                                                     dtype):
    """``ops.flash_attention(..., group=, q_head0=)`` on the CPU: query head
    i of the launch, the model's q_head0 + i, reads the model's kv head
    (q_head0 + i) // group, the first given being q_head0 // group's;
    against ``blockwise_attention`` on k / v expanded to the launch's heads
    by that map, and against the reference's kernel on them."""
    from repro_torch.models.attention import blockwise_attention
    arrays = _qkv(hq * 10 + q_head0, 2, hq, hkv, 96, 96, 32)
    q, k, v = _torch(arrays, dtype)
    got = tops.flash_attention(q, k, v, causal=True, window=40, group=group,
                               q_head0=q_head0)
    heads = [(q_head0 + i) // group - q_head0 // group for i in range(hq)]
    assert heads[-1] == hkv - 1
    idx = torch.tensor(heads)
    assert torch.equal(tref.expand_kv(k, hq, group, q_head0),
                       k.index_select(1, idx))
    want = blockwise_attention(q, k.index_select(1, idx),
                               v.index_select(1, idx), causal=True,
                               window=40, q_chunk=32, k_chunk=32)
    _assert_close(got, want.float().numpy(), dtype)
    kj, vj = (a[:, heads] for a in arrays[1:])
    _assert_close(got, jops.flash_attention(
        *_jax([arrays[0], kj, vj], dtype), causal=True, window=40,
        use_pallas=True).astype(jnp.float32), dtype)
    with pytest.raises(ValueError, match="kv heads"):
        tops.flash_attention(q, k[:, :-1], v[:, :-1], group=group,
                             q_head0=q_head0)
