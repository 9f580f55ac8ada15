"""Parity of trackiellm_tpu_torch.ops.quant with trackiellm_tpu.ops.quant.

Inputs are made with numpy from a seed and fed to the JAX function and to
its port. Layout functions (quantize, dequantize) must agree bit for bit;
matmuls to 1e-5 relative (f32 sums taken in another order). The W4A8 plain
version is held against the Pallas kernel itself, run in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trackiellm_tpu.ops import quant as jq
from trackiellm_tpu_torch.ops import quant as tq

GROUPS = [64, 256]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so this file does not crowd the
    other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(seed, k, n):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_and_dequantize_bit_identical(bits, group):
    w = _w(group + bits, 512, 384)
    jfn = jq.quantize_q4 if bits == 4 else jq.quantize_q8
    tfn = tq.quantize_q4 if bits == 4 else tq.quantize_q8
    jw = jfn(jnp.asarray(w), group)
    tw = tfn(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert tw.values.dtype == (torch.uint8 if bits == 4 else torch.int8)
    assert (tw.k, tw.n, tw.group_size) == (jw.k, jw.n, jw.group_size)
    np.testing.assert_array_equal(tq.dequantize(tw).numpy(),
                                  np.asarray(jq.dequantize(jw)))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [1, 7, 64])
def test_quantized_matmul_matches_xla(m, group):
    w = _w(m + group, 512, 256)
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    ref = np.asarray(jq.quantized_matmul_xla(jnp.asarray(x), jw))
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    out = tq.quantized_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # The dispatcher keeps leading axes, as the reference does.
    out3 = tq.quantized_matmul(torch.from_numpy(x)[None], tw)
    assert out3.shape == (1, m, 256)


@pytest.mark.parametrize("group", GROUPS)
def test_activation_quantization_bit_identical(group):
    x = np.random.default_rng(group).standard_normal((5, 1024)).astype(
        np.float32) * 3.0
    x[1, :group] = 0.0  # an all-zero group takes the 1e-12 scale floor
    jx, jsx, jsum = jq.quantize_activations_q8(jnp.asarray(x), group)
    tx, tsx, tsum = tq.quantize_activations_q8(torch.from_numpy(x), group)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("m", [1, 8, 32])
def test_w4a8_ref_matches_pallas_interpret(m, group):
    k, n = 1024, 256
    w = _w(7 * m + group, k, n)
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(
        np.float32)
    jw = jq.quantize_q4(jnp.asarray(w), group)
    ref = np.asarray(jq.q4_matmul_pallas_i8(
        jnp.asarray(x), jw.values, jw.scales, tile_n=128, tile_k=256,
        interpret=True))
    tw = tq.quantize_q4(torch.from_numpy(w), group)
    out = tq.q4_matmul_w4a8_ref(torch.from_numpy(x), tw.values, tw.scales)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel_l2(out.numpy(), ref) < 1e-5
    # The CPU wrapper takes the plain version, and only because the
    # tensor is on the CPU.
    wrapped = tq.q4_matmul_w4a8(torch.from_numpy(x), tw.values, tw.scales)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())


def test_w4a8_bf16_activations_follow_the_f32_path():
    """The model path hands bf16 activations to the matmul; both sides
    quantize them from their f32 value."""
    w = _w(3, 512, 128)
    x = np.random.default_rng(4).standard_normal((4, 512)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tw = tq.quantize_q4(torch.from_numpy(w), 64)
    jw = jq.quantize_q4(jnp.asarray(w), 64)
    ref = np.asarray(jq.q4_matmul_pallas_i8(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jw.values,
        jw.scales, tile_n=128, tile_k=128, interpret=True))
    out = tq.q4_matmul_w4a8_ref(xb, tw.values, tw.scales).numpy()
    assert _rel_l2(out, ref) < 1e-5


@pytest.mark.parametrize("m,expect_bm", [(1, 4), (4, 4), (8, 16), (16, 16),
                                         (64, 64), (512, 64)])
def test_w4a8_plan(m, expect_bm):
    """Tile rows cover M with the least waste; splits are whole groups,
    cover every group exactly once, and fill the card at decode."""
    for k, n in [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                 (4096, 32000)]:
        bm, splits, per_split = tq._w4a8_plan(m, k, n, 256)
        ngh = k // 2 // 256
        assert bm == expect_bm
        assert 1 <= splits <= ngh
        assert (splits - 1) * per_split < ngh <= splits * per_split
        blocks = -(-n // 64) * -(-m // bm) * splits
        assert blocks >= min(4 * 132, -(-n // 64) * -(-m // bm) * ngh)


def test_dispatch_rules():
    w = tq.quantize_q8(torch.from_numpy(_w(1, 256, 128)), 64)
    x = torch.ones((2, 256))
    # Q8 on the CPU is dequantize-then-matmul, as off the TPU.
    np.testing.assert_allclose(tq.quantized_matmul(x, w).numpy(),
                               (x @ tq.dequantize(w)).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tq.q4_matmul_w4a8(torch.ones((2, 100)), torch.zeros((64, 8),
                          dtype=torch.uint8), torch.ones((2, 8)))
    with pytest.raises(TypeError):
        tq.q4_matmul_w4a8(torch.ones((2, 128)), torch.zeros((64, 8),
                          dtype=torch.int8), torch.ones((2, 8)))
