"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports no JAX, so it runs on a host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX.)
"""

import json

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.models import llm
from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops import attention as ta
from trackiellm_tpu_torch.ops import diag as td
from trackiellm_tpu_torch.ops import fused as tf
from trackiellm_tpu_torch.ops import quant as tq
from trackiellm_tpu_torch.tools import capture

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


VARIANTS = {"causal": {}, "window": {"window": 100}, "softcap": {"softcap": 5.0},
            "scale": {"scale": 0.3}, "sinks": {"sinks": True}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_kernel_matches_plain(dev, variant, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((8, 512, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 512, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, 512, d), generator=g, device=dev).to(dtype)
    kw = dict(VARIANTS[variant])
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((8,), generator=g, device=dev)
    before = ta.flash_attention.launches
    got = ta.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = ta.attention_ref(q, k, v, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() < tol
    # The plain twin walks the same tiles.
    assert (ta.flash_attention_ref(q, k, v, **kw).float()
            - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("m", [1, 3, 8, 16, 64, 200])
@pytest.mark.parametrize("group", [64, 128, 256])
def test_w4a8_kernel_matches_plain(dev, m, group):
    g = torch.Generator(device=dev).manual_seed(m)
    w = tq.quantize_q4(torch.randn((1024, 320), generator=g, device=dev),
                       group)
    x = torch.randn((m, 1024), generator=g, device=dev)
    before = tq.q4_matmul_w4a8.launches
    got = tq.q4_matmul_w4a8(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert tq.q4_matmul_w4a8.launches == before + 1
    assert _rel_l2(got, tq.q4_matmul_w4a8_ref(x, w.values, w.scales)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("group", [64, 256])
def test_activation_quant_kernel_is_bit_exact(dev, group, dtype):
    """The one-launch activation quantization equals the plain version bit
    for bit, with an all-zero row (the 1e-12 floor) and a row of ties at .5
    (absmax 127 gives scale 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0)."""
    g = torch.Generator(device=dev).manual_seed(group)
    x = torch.randn((6, 4 * group), generator=g, device=dev) * 3.0
    x[1] = 0.0
    ties = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                        device=dev)
    x[2] = ties.repeat(x.shape[1] // ties.numel())
    x = x.to(dtype)
    before = tq.quantize_activations.launches
    got = tq.quantize_activations(x, group)
    torch.cuda.synchronize()
    assert tq.quantize_activations.launches == before + 1
    want = tq.quantize_activations_q8(x, group)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert got[0][2, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert torch.equal(got[1][1], torch.zeros_like(got[1][1]))


@pytest.mark.parametrize("n", [4, 68, 4096])
@pytest.mark.parametrize("m", [1, 3, 16, 17, 64, 100, 512])
@pytest.mark.parametrize("group", [64, 256])
def test_w4a8_kernel_one_group_per_half(dev, group, m, n):
    """K = 2G (one group per half), N narrower than a 128-column tile and
    not a multiple of 16, and M on both sides of the 16-row tile: the
    kernel follows the plain version and repeats itself bit for bit."""
    g = torch.Generator(device=dev).manual_seed(m * n + group)
    w = tq.quantize_q4(torch.randn((2 * group, n), generator=g, device=dev),
                       group)
    x = torch.randn((m, 2 * group), generator=g, device=dev).to(
        torch.bfloat16)
    got = tq.q4_matmul_w4a8(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel_l2(got, tq.q4_matmul_w4a8_ref(x, w.values, w.scales)) < 1e-5
    assert torch.equal(got, tq.q4_matmul_w4a8(x, w.values, w.scales))


def test_w4a8_launches_one_quantization_per_matmul(dev):
    w = tq.quantize_q4(torch.randn((1024, 256), device=dev), 256)
    before = (tq.quantize_activations.launches, tq.q4_matmul_w4a8.launches)
    for m in (1, 40):
        tq.q4_matmul_w4a8(torch.randn((m, 1024), device=dev), w.values,
                          w.scales)
    assert (tq.quantize_activations.launches - before[0],
            tq.q4_matmul_w4a8.launches - before[1]) == (2, 2)


def test_w4a8_refuses_other_dtypes_before_launching(dev):
    w = tq.quantize_q4(torch.randn((512, 256), device=dev), 64)
    before = (tq.quantize_activations.launches, tq.q4_matmul_w4a8.launches)
    with pytest.raises(TypeError):
        tq.q4_matmul_w4a8(torch.ones((2, 512), dtype=torch.float64,
                                    device=dev), w.values, w.scales)
    assert (tq.quantize_activations.launches,
            tq.q4_matmul_w4a8.launches) == before


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["window17"])
@pytest.mark.parametrize("s", [64, 256, 512])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_bf16_flash_tensor_core_kernel(dev, d, s, variant):
    """The bf16 kernel against its plain twin (same tiles, P rounded to
    bf16) and the dense oracle, with a window shorter than a key tile."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn((h, s, d), generator=g, device=dev).to(
        torch.bfloat16) for h in (8, 2, 2))
    kw = {"window": 17} if variant == "window17" else dict(VARIANTS[variant])
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((8,), generator=g, device=dev)
    got = ta.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    for ref in (ta.flash_attention_ref(q, k, v, **kw),
                ta.attention_ref(q, k, v, **kw)):
        assert _rel_l2(got, ref) < 1e-2
        assert (got.float() - ref.float()).abs().max().item() < 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 256])
def test_flash_at_family_head_dims(dev, d, dtype):
    """Phi-3's D = 96 (32 heads, window 2047) and Gemma-2's D = 256 (16/8
    heads, window 512, softcap 50, query scalar 256) at S = 1024 against
    the plain twin; the kernels' registers stay under the cap and spill
    nothing."""
    h, hk, kw = ((32, 32, {"window": 2047}) if d == 96 else
                 (16, 8, {"window": 512, "softcap": 50.0, "scale": 1 / 16}))
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn((n, 1024, d), generator=g, device=dev).to(dtype)
               for n in (h, hk, hk))
    got = ta.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = ta.flash_attention_ref(q, k, v, **kw)
    assert _rel_l2(got, ref) < (1e-5 if dtype == torch.float32 else 1e-2)
    attrs = ta.flash_kernel_attrs(d, dtype)
    assert 0 < attrs["regs"] <= 255 and attrs["local_bytes"] == 0


def test_f32_flash_keeps_f32_math(dev):
    """f32 stays on the CUDA-core kernel: within 1e-5 of its plain twin,
    which bf16 products could not reach."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((8, 256, 128), generator=g, device=dev)
               for _ in range(3))
    k, v = k[:2].contiguous(), v[:2].contiguous()
    got = ta.flash_attention(q, k, v, window=100)
    assert got.dtype == torch.float32
    assert _rel_l2(got, ta.flash_attention_ref(q, k, v, window=100)) < 1e-5


def test_w4a8_kernel_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = tq.quantize_q4(torch.randn((4096, 4096), generator=g, device=dev))
    x = torch.randn((1, 4096), generator=g, device=dev)
    a = tq.q4_matmul_w4a8(x, w.values, w.scales)
    b = tq.q4_matmul_w4a8(x, w.values, w.scales)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(4096, 1024), (14336, 4096)])
def test_weight_quantizers_give_the_cpu_bytes(dev, shape, bits):
    """A weight quantized on the card has the CPU's bytes (the JAX
    package's: its eager quantizers divide exactly on the CPU). The
    absmax / qmax scales divide by a device tensor; a Python divisor would
    turn into a product with its reciprocal on CUDA and move many scales
    by an ulp. The bf16 cast that a conversion applies to norms and
    embeddings rounds alike on both."""
    w = torch.from_numpy(np.random.default_rng(shape[0] + bits)
                         .standard_normal(shape, dtype=np.float32))
    quantize = tq.quantize_q4 if bits == 4 else tq.quantize_q8
    cpu = quantize(w, 256)
    card = quantize(w.to(dev), 256)
    assert torch.equal(card.scales.cpu().view(torch.int32),
                       cpu.scales.view(torch.int32))
    assert torch.equal(card.values.cpu(), cpu.values)
    assert torch.equal(w.to(dev).to(torch.bfloat16).cpu().view(torch.int16),
                       w.to(torch.bfloat16).view(torch.int16))


def test_quantized_matmul_dispatch_on_the_card(dev, monkeypatch):
    monkeypatch.delenv("TRACKIE_Q4_F32A", raising=False)
    w = tq.quantize_q4(torch.randn((512, 256), device=dev), 64)
    before = tq.q4_matmul_w4a8.launches
    tq.quantized_matmul(torch.randn((2, 3, 512), device=dev), w)
    assert tq.q4_matmul_w4a8.launches == before + 1
    f32a_big = tq.q4_matmul_f32a.launches
    big = tq.quantized_matmul(torch.randn((513, 512), device=dev), w)
    assert tq.q4_matmul_w4a8.launches == before + 1  # M > 512: f32a route
    assert tq.q4_matmul_f32a.launches == f32a_big + 1
    assert big.shape == (513, 256)
    q8 = tq.quantize_q8(torch.randn((512, 256), device=dev), 64)
    q8_before = tq.q8_matmul.launches
    tq.quantized_matmul(torch.randn((2, 512), device=dev), q8)
    assert tq.q8_matmul.launches == q8_before + 1
    monkeypatch.setenv("TRACKIE_Q4_F32A", "1")
    f32a_before = tq.q4_matmul_f32a.launches
    tq.quantized_matmul(torch.randn((2, 512), device=dev), w)
    assert tq.q4_matmul_f32a.launches == f32a_before + 1
    assert tq.q4_matmul_w4a8.launches == before + 1


@pytest.mark.parametrize("lever", [None, "1"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [513, 1024, 1500])
def test_quantized_matmul_above_512_rows(dev, monkeypatch, m, dtype, bits,
                                         lever):
    """M > 512 on the card: Q4 takes the f32a kernel whatever the lever,
    Q8 its kernel, both on the exact activations (no int8 quantization,
    no plain path), against the plain dequantize-then-matmul."""
    if lever is None:
        monkeypatch.delenv("TRACKIE_Q4_F32A", raising=False)
    else:
        monkeypatch.setenv("TRACKIE_Q4_F32A", lever)
    plain_calls = []
    ref = tq.quantized_matmul_ref
    monkeypatch.setattr(tq, "quantized_matmul_ref",
                        lambda *a: plain_calls.append(1) or ref(*a))
    g = torch.Generator(device=dev).manual_seed(m + bits)
    quant = tq.quantize_q4 if bits == 4 else tq.quantize_q8
    w = quant(torch.randn((1024, 320), generator=g, device=dev), 64)
    x = torch.randn((m, 1024), generator=g, device=dev).to(dtype)
    kernel = tq.q4_matmul_f32a if bits == 4 else tq.q8_matmul
    counts = (kernel.launches, tq.q4_matmul_w4a8.launches,
              tq.quantize_activations.launches)
    got = tq.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert (kernel.launches, tq.q4_matmul_w4a8.launches,
            tq.quantize_activations.launches) == (counts[0] + 1, *counts[1:])
    assert plain_calls == []
    assert got.dtype == torch.float32 and got.shape == (m, 320)
    assert _rel_l2(got, ref(x, w)) < 1e-5


def test_dense_linear_reads_bf16_weights_without_a_copy(dev):
    """A dense bf16 weight on the card: bf16 products with f32 sums, within
    bf16's rounding of the CPU's f32 route, and no copy of the weight."""
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((1024, 768), generator=g, device=dev).bfloat16()
    for m in (1, 40, 600):
        x = torch.randn((m, 1024), generator=g, device=dev).bfloat16()
        got = llm._linear(x, w)
        want = llm._linear(x.cpu(), w.cpu())
        assert got.dtype == torch.bfloat16 and got.shape == (m, 768)
        assert _rel_l2(got.cpu(), want) < 1e-2
        assert _cache_copies(lambda: llm._linear(x, w), w.shape) == []
    assert _cache_copies(lambda: llm._linear(x.cpu(), w.cpu()),
                         w.shape) != []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_of_a_row_does_not_depend_on_the_batch(dev, dtype):
    """A row's RMS norm on the card has the same bits whether the call
    holds it alone or among 16 rows, as a decode step and a verify pass
    hold it, and stays within rounding of the CPU's f32 route."""
    g = torch.Generator(device=dev).manual_seed(3)
    scale = torch.exp(torch.randn((64, 16, 1), generator=g, device=dev))
    x = (torch.randn((64, 16, 4096), generator=g, device=dev)
         * scale).to(dtype)
    norm = (1 + 0.1 * torch.randn((4096,), generator=g, device=dev)).to(dtype)
    for batch in x:
        rows = llm._rms_norm(batch, norm, 1e-5)
        for i in range(16):
            assert torch.equal(rows[i:i + 1],
                               llm._rms_norm(batch[i:i + 1], norm, 1e-5))
    want = llm._rms_norm(x[0].cpu(), norm.cpu(), 1e-5)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
    assert _rel_l2(llm._rms_norm(x[0], norm, 1e-5).cpu(), want) < tol


MISTRAL_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                  (4096, 32000)]
F32A_KERNELS = {"q8": (tq.quantize_q8, tq.q8_matmul, tq.q8_matmul_ref),
                "f32a": (tq.quantize_q4, tq.q4_matmul_f32a,
                         tq.q4_matmul_f32a_ref)}


@pytest.mark.parametrize("kind", sorted(F32A_KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 8, 16, 64, 200])
@pytest.mark.parametrize("group", [64, 256])
def test_f32a_kernels_match_plain(dev, kind, dtype, m, group):
    quant, kernel, plain = F32A_KERNELS[kind]
    g = torch.Generator(device=dev).manual_seed(m + group)
    w = quant(torch.randn((1024, 320), generator=g, device=dev), group)
    x = torch.randn((m, 1024), generator=g, device=dev).to(dtype)
    before = kernel.launches
    got = kernel(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, 320)
    assert _rel_l2(got, plain(x, w.values, w.scales)) < 1e-5
    # Deterministic: the K splits are summed in a fixed order.
    assert torch.equal(got, kernel(x, w.values, w.scales))


@pytest.mark.parametrize("m", [1, 3, 15, 16, 17, 63, 64, 65, 200, 512])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
def test_q8_tensor_core_kernel_matches_plain(dev, group, m):
    """bf16 x takes the tensor-core kernel on both sides of the 16-row
    decode tile (G = 32 takes the 64-row tile's 32-row chunks); N = 320
    leaves a column tail of 64 in the last tile."""
    g = torch.Generator(device=dev).manual_seed(1000 * group + m)
    w = tq.quantize_q8(torch.randn((1024, 320), generator=g, device=dev),
                       group)
    x = torch.randn((m, 1024), generator=g, device=dev).to(torch.bfloat16)
    before = tq.q8_matmul.launches
    got = tq.q8_matmul(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert tq.q8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, 320)
    assert _rel_l2(got, tq.q8_matmul_ref(x, w.values, w.scales)) < 1e-5
    assert torch.equal(got, tq.q8_matmul(x, w.values, w.scales))


@pytest.mark.parametrize("n", [4, 68, 4096])
@pytest.mark.parametrize("m", [1, 16, 17, 100])
def test_q8_tensor_core_kernel_one_group_and_narrow(dev, m, n):
    """K = G (one group, four chunks: fewer than the ring's stages), N
    narrower than a tile and not a multiple of 16 (4-byte copies), and the
    weights at an offset of 4 bytes (4-byte copies at N = 4096)."""
    g = torch.Generator(device=dev).manual_seed(m * n)
    w = tq.quantize_q8(torch.randn((128, n), generator=g, device=dev), 128)
    x = torch.randn((m, 128), generator=g, device=dev).to(torch.bfloat16)
    got = tq.q8_matmul(x, w.values, w.scales)
    ref = tq.q8_matmul_ref(x, w.values, w.scales)
    assert _rel_l2(got, ref) < 1e-5
    buf = torch.zeros(4 + w.values.numel(), dtype=torch.int8, device=dev)
    shifted = buf[4:].view_as(w.values)
    shifted.copy_(w.values)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(tq.q8_matmul(x, shifted, w.scales), got)


@pytest.mark.parametrize("m", [1, 3, 15, 16, 17, 63, 64, 65, 200, 512])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
def test_f32a_tensor_core_kernel_matches_plain(dev, group, m):
    """bf16 x takes the f32a tensor-core kernel on both sides of the 16-row
    decode tile (G = 32 takes the 64-row tile's 32-row chunks); N = 320
    leaves a column tail of 64 in the last tile."""
    g = torch.Generator(device=dev).manual_seed(2000 * group + m)
    w = tq.quantize_q4(torch.randn((1024, 320), generator=g, device=dev),
                       group)
    x = torch.randn((m, 1024), generator=g, device=dev).to(torch.bfloat16)
    before = tq.q4_matmul_f32a.launches
    got = tq.q4_matmul_f32a(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert tq.q4_matmul_f32a.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, 320)
    assert _rel_l2(got, tq.q4_matmul_f32a_ref(x, w.values, w.scales)) < 1e-5
    assert torch.equal(got, tq.q4_matmul_f32a(x, w.values, w.scales))


def _q4_from_ints(q, scales):
    """The integer weights q (K, N) in [-8, 7], packed as quantize_q4 packs
    them (it never gives -8), with the given scales."""
    half = q.shape[0] // 2
    lo = (q[:half] + 8).to(torch.uint8)
    hi = (q[half:] & 0xF).to(torch.uint8)
    return tq.QuantizedLinear(values=lo | (hi << 4), scales=scales)


@pytest.mark.parametrize("n", [4, 68, 4096])
@pytest.mark.parametrize("m", [1, 16, 17, 100])
@pytest.mark.parametrize("group", [32, 128])
def test_f32a_tensor_core_kernel_one_group_per_half(dev, group, m, n):
    """K = 2G: one group in each half. The high half's weights are the two
    extremes of its two's complement nibble, -8 in even columns and 7 in
    odd ones, the low half's random over [-8, 7]. N narrower than a tile
    and, at 4 and 68, not a multiple of 16 (4-byte copies); then the packed
    weights at an offset of 4 bytes (4-byte copies at N = 4096)."""
    g = torch.Generator(device=dev).manual_seed(group * m + n)
    k = 2 * group
    q = torch.randint(-8, 8, (k, n), generator=g, device=dev,
                      dtype=torch.int32)
    q[group:] = torch.where(torch.arange(n, device=dev) % 2 == 0, -8, 7)
    scales = torch.rand((2, n), generator=g, device=dev) + 0.5
    w = _q4_from_ints(q, scales)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got = tq.q4_matmul_f32a(x, w.values, w.scales)
    assert _rel_l2(got, tq.q4_matmul_f32a_ref(x, w.values, w.scales)) < 1e-5
    dense = (q.float().reshape(2, group, n) * scales[:, None, :]).reshape(
        k, n)
    assert _rel_l2(got, x.float() @ dense) < 1e-5
    buf = torch.zeros(4 + w.values.numel(), dtype=torch.uint8, device=dev)
    shifted = buf[4:].view_as(w.values)
    shifted.copy_(w.values)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(tq.q4_matmul_f32a(x, shifted, w.scales), got)


@pytest.mark.parametrize("m", [5, 40])
def test_f32a_tensor_core_kernel_nonfinite_rows(dev, m):
    """A NaN in the low half's activations and a +Inf and a -Inf in the
    high half's: the outputs are non-finite in exactly the rows where the
    plain version's are, and the other rows agree with it."""
    g = torch.Generator(device=dev).manual_seed(m)
    w = tq.quantize_q4(torch.randn((1024, 320), generator=g, device=dev),
                       256)
    x = torch.randn((m, 1024), generator=g, device=dev).to(torch.bfloat16)
    x[0, 3] = float("nan")
    x[2, 512 + 7] = float("inf")
    x[3, 1023] = -float("inf")
    got = tq.q4_matmul_f32a(x, w.values, w.scales)
    ref = tq.q4_matmul_f32a_ref(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    bad = (~torch.isfinite(got)).all(dim=1).tolist()
    assert bad == [True, False, True, True] + [False] * (m - 4)
    finite = [1] + list(range(4, m))
    assert _rel_l2(got[finite], ref[finite]) < 1e-5


def test_nonfinite_activations_on_the_card(dev):
    """A NaN and an Inf activation through the quantization kernel and
    W4A8: sx equals the plain version's, NaN and inf included; sxsum and the
    output are non-finite exactly where the plain version's are. xq of a
    non-finite group is not compared (the int8 cast of NaN is undefined)."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((4, 1024), generator=g, device=dev)
    x[0, 3] = float("nan")
    x[2, 256 + 7] = float("inf")
    x[3, 1023] = -float("inf")
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        _, sx, sxsum = tq.quantize_activations(xd, 256)
        _, sx_ref, sxsum_ref = tq.quantize_activations_q8(xd, 256)
        torch.cuda.synchronize()
        torch.testing.assert_close(sx, sx_ref, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(torch.isfinite(sxsum), torch.isfinite(sxsum_ref))
        assert torch.isnan(sx[0, 0]) and torch.isinf(sx[2, 1])
        w = tq.quantize_q4(torch.randn((1024, 320), generator=g, device=dev),
                           256)
        got = tq.q4_matmul_w4a8(xd, w.values, w.scales)
        ref = tq.q4_matmul_w4a8_ref(xd, w.values, w.scales)
        torch.cuda.synchronize()
        assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
        assert (~torch.isfinite(got)).all(dim=1).tolist() == [
            True, False, True, True]
        assert _rel_l2(got[1], ref[1]) < 1e-5


@pytest.mark.parametrize("kind", sorted(F32A_KERNELS))
@pytest.mark.parametrize("k,n", MISTRAL_SHAPES)
@pytest.mark.parametrize("m", [1, 512])
def test_f32a_kernels_at_mistral_shapes(dev, kind, k, n, m):
    quant, kernel, plain = F32A_KERNELS[kind]
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    w = quant(torch.randn((k, n), generator=g, device=dev) / k ** 0.5)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    assert _rel_l2(kernel(x, w.values, w.scales),
                   plain(x, w.values, w.scales)) < 1e-5


@pytest.mark.parametrize("kind", sorted(F32A_KERNELS))
def test_f32a_kernels_refuse_bad_operands(dev, kind):
    quant, kernel, _ = F32A_KERNELS[kind]
    w = quant(torch.randn((512, 64), device=dev), 64)
    with pytest.raises(TypeError):
        kernel(torch.ones((2, 512), device=dev, dtype=torch.float16),
               w.values, w.scales)
    with pytest.raises(ValueError):     # K mismatch
        kernel(torch.ones((2, 256), device=dev), w.values, w.scales)
    with pytest.raises(ValueError):     # weights on another device
        kernel(torch.ones((2, 512), device=dev), w.values.cpu(),
               w.scales.cpu())
    with pytest.raises(ValueError):     # G % 32 != 0
        w16 = quant(torch.randn((512, 64), device=dev), 16)
        kernel(torch.ones((2, 512), device=dev), w16.values, w16.scales)


QUANT_KERNELS = {
    "w4a8": (tq.quantize_q4, tq.q4_matmul_w4a8, tq.q4_matmul_w4a8_ref),
    "f32a": (tq.quantize_q4, tq.q4_matmul_f32a, tq.q4_matmul_f32a_ref),
    "q8": (tq.quantize_q8, tq.q8_matmul, tq.q8_matmul_ref),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 16, 17])
@pytest.mark.parametrize("n", [6, 49155])
@pytest.mark.parametrize("kind", sorted(QUANT_KERNELS))
def test_quant_kernels_take_a_ragged_n(dev, kind, n, m, dtype):
    """N % 4 != 0 (Granite-3's vocabulary of 49,155): each kernel takes the
    ragged last tile itself, byte loads and all, against its plain
    version."""
    quant, kernel, plain = QUANT_KERNELS[kind]
    g = torch.Generator(device=dev).manual_seed(n + m)
    w = quant(torch.randn((512, n), generator=g, device=dev) / 512 ** 0.5,
              128)
    x = torch.randn((m, 512), generator=g, device=dev).to(dtype)
    got = kernel(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert _rel_l2(got, plain(x, w.values, w.scales)) < 1e-5


@pytest.mark.parametrize("k,n,group", [(2304, 9216, 128), (1152, 6912, 64),
                                       (13696, 4096, 64), (3840, 15360, 128)])
@pytest.mark.parametrize("m", [1, 64])
def test_w4a8_at_family_groups(dev, k, n, group, m):
    """W4A8 at the groups the families take where 256 does not divide K/2
    (Gemma-2-2B's w_gu, Gemma-3-1B's, GLM-4's w_down, Gemma-3-12B's)."""
    g = torch.Generator(device=dev).manual_seed(k + m)
    w = tq.quantize_q4(torch.randn((k, n), generator=g, device=dev)
                       / k ** 0.5, group)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    assert _rel_l2(tq.q4_matmul_w4a8(x, w.values, w.scales),
                   tq.q4_matmul_w4a8_ref(x, w.values, w.scales)) < 1e-5


def test_gemma2_prefill_on_the_card_matches_cpu(dev):
    """A 2-layer Gemma-2-2B (published widths: D = 256, GeGLU, sandwich
    norms, softcaps, the alternating window cut to 128 so that bucket 256
    masks) as Q4 at group 128: prefill at bucket 256 (flash on every layer)
    and three decode steps on the card against the CPU."""
    cfg = llm.LLMConfig.gemma2_2b()._replace(n_layers=2, max_seq=512,
                                             sliding_window=128)
    p_gpu = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(0), cfg, group=128,
        dtype=torch.float32, device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256000, 256))
    before = ta.flash_attention.launches
    lg, cg = llm.prefill(p_gpu, cfg, toks.to(dev), 250,
                         llm.KVCache.create(cfg, torch.float32, device=dev))
    lc, cc = llm.prefill(p_cpu, cfg, toks, 250,
                         llm.KVCache.create(cfg, torch.float32, device="cpu"))
    assert ta.flash_attention.launches == before + cfg.n_layers
    assert _rel_l2(lg.cpu(), lc) < 5e-2
    for tok in (5, 77, 300):
        lg, cg = llm.decode_step(p_gpu, cfg, tok, cg)
        lc, cc = llm.decode_step(p_cpu, cfg, tok, cc)
        assert _rel_l2(lg.cpu(), lc) < 5e-2


def _fused_operands(dev, m, d, h, g, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
    norm = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
    w_gu = tq.quantize_q4(torch.randn((d, 2 * h), generator=gen, device=dev)
                          / d ** 0.5, g)
    w_down = tq.quantize_q4(torch.randn((h, d), generator=gen, device=dev)
                            / h ** 0.5, g)
    return x, norm, w_gu, w_down


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("d,h,g", [(256, 512, 64), (256, 512, 128),
                                   (512, 1024, 64), (512, 1024, 128),
                                   (512, 1024, 256), (4096, 14336, 64),
                                   (4096, 14336, 128), (4096, 14336, 256)])
def test_fused_kernel_matches_plain(dev, d, h, g, m, dtype):
    """Every M the block takes, every group size, small widths and
    Mistral-7B's: FUSED_TOL (rel L2 1e-5 in f32, 1e-2 in bf16), one launch,
    and the same call twice gives the same bits."""
    x, norm, w_gu, w_down = _fused_operands(dev, m, d, h, g, dtype, seed=m)
    before = tf.fused_mlp_q4.launches
    got = tf.fused_mlp_q4(x, norm, w_gu.values, w_gu.scales, w_down.values,
                          w_down.scales)
    torch.cuda.synchronize()
    assert tf.fused_mlp_q4.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = tf.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_l2(got, ref) < tol
    assert torch.equal(got, tf.fused_mlp_q4(
        x, norm, w_gu.values, w_gu.scales, w_down.values, w_down.scales))


@pytest.mark.parametrize("m", [1, 5, 8])
def test_fused_kernel_uneven_split(dev, m):
    """H/2 = 640 pairs at D = 1024: neither phase's units
    divide evenly over the grid, so tiles and slices fall to two blocks or
    more, whose partials the first block adds; the flags are left clear for
    the next call."""
    d, h, g = 1024, 1280, 64
    plan = tf.fused_plan(m, d, h, g, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.units_a % plan.blocks and plan.units_b % plan.blocks
    x, norm, w_gu, w_down = _fused_operands(dev, m, d, h, g, torch.float32,
                                            seed=m)
    args = (x, norm, w_gu.values, w_gu.scales, w_down.values, w_down.scales)
    got = tf.fused_mlp_q4(*args)
    ref = tf.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) < 1e-5
    for _ in range(3):
        assert torch.equal(got, tf.fused_mlp_q4(*args))
    torch.cuda.synchronize()
    assert not tf._flags(x.device).any()


def test_fused_kernel_nonfinite_rows(dev):
    """NaN, +Inf and -Inf in x give non-finite output rows exactly where
    fused_mlp_ref gives them; the finite rows keep FUSED_TOL."""
    for dtype in (torch.float32, torch.bfloat16):
        x, norm, w_gu, w_down = _fused_operands(dev, 5, 512, 1024, 128,
                                                dtype, seed=9)
        x[0, 3] = float("nan")
        x[2, 300] = float("inf")
        x[3, 511] = -float("inf")
        got = tf.fused_mlp_q4(x, norm, w_gu.values, w_gu.scales,
                              w_down.values, w_down.scales)
        ref = tf.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)
        torch.cuda.synchronize()
        bad = (~torch.isfinite(got)).any(dim=1).tolist()
        assert bad == (~torch.isfinite(ref)).any(dim=1).tolist()
        assert bad == [True, False, True, True, False]
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for row in (1, 4):
            assert _rel_l2(got[row], ref[row]) < tol


def test_fused_kernel_in_a_cuda_graph(dev):
    """The cooperative launch captured in a CUDA graph (the decode graph's
    route) replays to the eager bits; only the warm-up and the capture
    count as launches."""
    x, norm, w_gu, w_down = _fused_operands(dev, 1, 4096, 14336, 256,
                                            torch.bfloat16, seed=3)
    args = (x, norm, w_gu.values, w_gu.scales, w_down.values, w_down.scales)
    before = tf.fused_mlp_q4.launches
    replay = capture(lambda: tf.fused_mlp_q4(*args), dev)
    assert tf.fused_mlp_q4.launches == before + 3
    for _ in range(2):
        out = replay()
    torch.cuda.synchronize()
    assert tf.fused_mlp_q4.launches == before + 3
    assert torch.equal(out, tf.fused_mlp_q4(*args))


def test_fused_kernel_takes_mixed_norm_dtype(dev):
    x, norm, w_gu, w_down = _fused_operands(dev, 2, 256, 512, 128,
                                            torch.float32)
    norm = norm.to(torch.bfloat16)
    got = tf.fused_mlp_q4(x, norm, w_gu.values, w_gu.scales, w_down.values,
                          w_down.scales)
    assert _rel_l2(got, tf.fused_mlp_ref(x, norm, w_gu, w_down, 1e-5)) < 1e-5


def test_fused_kernel_refuses_bad_operands(dev):
    x, norm, w_gu, w_down = _fused_operands(dev, 2, 256, 512, 128,
                                            torch.float32)
    args = (w_gu.values, w_gu.scales, w_down.values, w_down.scales)
    with pytest.raises(ValueError):     # M > 8
        tf.fused_mlp_q4(x.repeat(5, 1), norm, *args)
    with pytest.raises(TypeError):
        tf.fused_mlp_q4(x.half(), norm, *args)
    with pytest.raises(ValueError):     # D mismatch
        tf.fused_mlp_q4(x[:, :128], norm[:128], *args)
    with pytest.raises(ValueError):     # weights on another device
        tf.fused_mlp_q4(x, norm, w_gu.values.cpu(), w_gu.scales.cpu(),
                        w_down.values.cpu(), w_down.scales.cpu())


def test_tiny_model_with_both_levers_on_the_card(dev, monkeypatch):
    """TRACKIE_Q4_F32A=1 and TRACKIE_FUSED_MLP=1: prefill takes the f32a
    kernel, decode the fused block; the logits follow the CPU path."""
    monkeypatch.setenv("TRACKIE_Q4_F32A", "1")
    monkeypatch.setenv("TRACKIE_FUSED_MLP", "1")
    cfg = llm.LLMConfig.tiny()._replace(max_seq=512, sliding_window=512)
    p_gpu = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(1), cfg, group=128,
        dtype=torch.float32, device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 64))
    counts = (tq.q4_matmul_f32a.launches, tf.fused_mlp_q4.launches,
              tq.q4_matmul_w4a8.launches)
    lg, cg = llm.prefill(p_gpu, cfg, toks.to(dev), 50,
                         llm.KVCache.create(cfg, torch.float32, device=dev))
    lc, cc = llm.prefill(p_cpu, cfg, toks, 50,
                         llm.KVCache.create(cfg, torch.float32, device="cpu"))
    assert _rel_l2(lg.cpu(), lc) < 1e-4
    for tok in (5, 77, 300):
        lg, cg = llm.decode_step(p_gpu, cfg, tok, cg)
        lc, cc = llm.decode_step(p_cpu, cfg, tok, cc)
        assert _rel_l2(lg.cpu(), lc) < 1e-4
    assert tq.q4_matmul_f32a.launches > counts[0]
    assert tf.fused_mlp_q4.launches == counts[1] + 3 * cfg.n_layers
    assert tq.q4_matmul_w4a8.launches == counts[2]


def test_tiny_model_on_the_card_matches_cpu(dev):
    """Prefill at buckets 64 (dense attention) and 256 (flash) on the card
    against the port's CPU path on the same weights; then greedy text at
    lookahead 1 and 4 on the card is identical."""
    cfg = llm.LLMConfig.tiny()._replace(max_seq=512, sliding_window=512)
    p_gpu = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(0), cfg, group=64,
        dtype=torch.float32, device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, 256))
    for bucket in (64, 256):
        before = ta.flash_attention.launches
        lg, _ = llm.prefill(p_gpu, cfg, toks[:bucket].to(dev), bucket - 3,
                            llm.KVCache.create(cfg, torch.float32, device=dev))
        lc, _ = llm.prefill(p_cpu, cfg, toks[:bucket], bucket - 3,
                            llm.KVCache.create(cfg, torch.float32,
                                               device="cpu"))
        assert ta.flash_attention.launches == before + (
            cfg.n_layers if bucket == 256 else 0)
        assert _rel_l2(lg.cpu(), lc) < 5e-2
    texts = []
    for la in (1, 4):
        r = LLMRunner(p_gpu, cfg, gen_config=GenerationConfig(
            max_tokens=40, temperature=0.0, lookahead=la),
            cache_dtype=torch.float32, device="cuda")
        texts.append(r.generate("ola, tudo bem?"))
    assert texts[0] == texts[1]


def _tiny_q8_runners(dev, **gen_kw):
    """A tiny f32 Q8 model (the Q8 kernel: exact activations, so the card
    follows the CPU to f32 rounding) behind a runner on the card and one on
    the CPU, greedy unless ``temperature`` is given."""
    cfg = llm.LLMConfig.tiny()._replace(max_seq=512, sliding_window=512)
    p_gpu = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(7), cfg, bits=8, group=64,
        dtype=torch.float32, device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    gen_kw.setdefault("max_tokens", 48)
    gen_kw.setdefault("temperature", 0.0)
    return [LLMRunner(p, cfg, gen_config=GenerationConfig(**gen_kw),
                      cache_dtype=torch.float32, device=d)
        for p, d in ((p_gpu, dev), (p_cpu, torch.device("cpu")))]


def test_tiny_tool_call_on_the_card_matches_cpu(dev):
    """A forced tool call with an argument schema, then a tool response and
    a JSON reply: the card's text is the CPU route's, and it parses."""
    from trackiellm_tpu_torch.llm.runner import ToolDefinition
    schema = {"type": "object", "required": ["dir"],
              "properties": {"dir": {"type": "string",
                                     "enum": ["left", "right"]}}}
    tools = [ToolDefinition("go", "move", {"dir": "where"}, schema),
             ToolDefinition("stop", "wait", {})]
    before = tq.q8_matmul.launches
    outs = []
    for r in _tiny_q8_runners(dev, speculative=False):
        text = r.generate("a door ahead, where to?", tools=tools,
                          force_tool_call=True)
        call = r.parse_tool_call()
        r.add_tool_response(call["name"], {"ok": True})
        outs.append((text, call, r.generate("and now?", json_mode=True)))
    assert tq.q8_matmul.launches > before
    assert outs[0] == outs[1]
    assert outs[0][1]["name"] in ("go", "stop")
    json.loads(outs[0][2])


def test_tiny_speculation_on_the_card_matches_cpu(dev):
    """Greedy speculation (short n-grams, so passes fire) on the card: the
    CPU route's ids and counters, and the card's plain ids."""
    ids = []
    for r in _tiny_q8_runners(dev, speculative=True, spec_min_ngram=1):
        r.generate("abc abc abc abc ab")
        ids.append((r.generated_ids, r.spec_stats))
    plain = _tiny_q8_runners(dev, speculative=False)[0]
    plain.generate("abc abc abc abc ab")
    assert ids[0] == ids[1] and ids[0][1]["passes"] > 0
    assert plain.generated_ids == ids[0][0]


def test_tiny_sampled_speculation_on_the_card(dev, monkeypatch):
    """Sampled speculation (temperature 0.7, short n-grams) on the card:
    the rejection-sampling verify runs on card tensors with the card's
    generator, passes fire, two runs from one seed agree, and the cache
    holds exactly the emitted tokens."""
    from trackiellm_tpu_torch.llm import sampling
    verify, seen = sampling.spec_verify_sampled, []

    def watched(logits, proposal, n_prop, generator, *args, **kw):
        seen.append((logits.device.type, proposal.device.type,
                     generator.device.type))
        return verify(logits, proposal, n_prop, generator, *args, **kw)
    monkeypatch.setattr(sampling, "spec_verify_sampled", watched)
    outs = []
    for _ in range(2):
        r = _tiny_q8_runners(dev, speculative=True, spec_min_ngram=1,
                             temperature=0.7, seed=5, max_tokens=64)[0]
        outs.append((r.generate("abc abc abc abc ab"), r.generated_ids))
        assert r.spec_stats["passes"] > 0, r.spec_stats
        assert r._host_len == len(r._committed_ids) == r.cache.length
    assert outs[0] == outs[1]
    assert set(seen) == {("cuda", "cuda", "cuda")}


# (tile_k, tile_n): the card defaults, the narrowest tile ("G": tile_k one
# group), wider ones, and one stage holding all of K/2.
STREAM_TILES = [(tq.STREAM_TILE_K, tq.STREAM_TILE_N), ("G", 16), (256, 16),
                (256, 64), (512, 128), (256, 256), (1024, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 17, 20])
@pytest.mark.parametrize("tiles", STREAM_TILES)
@pytest.mark.parametrize("group", [64, 256])
def test_stream_matmul_kernel_matches_plain(dev, group, tiles, m, dtype):
    tile_k, tile_n = tiles
    tile_k = group if tile_k == "G" else tile_k
    g = torch.Generator(device=dev).manual_seed(m + group + tile_n)
    w = tq.quantize_q4(torch.randn((2048, 512), generator=g, device=dev),
                       group)
    x = torch.randn((m, 2048), generator=g, device=dev).to(dtype)
    before = tq.q4_matmul_stream.launches
    got = tq.q4_matmul_stream(x, w.values, w.scales, tile_n=tile_n,
                              tile_k=tile_k)
    torch.cuda.synchronize()
    assert tq.q4_matmul_stream.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, 512)
    assert _rel_l2(got, tq.q4_matmul_stream_ref(x, w.values, w.scales)) < 1e-5
    # Every sum has a fixed order: the same call gives the same bits.
    assert torch.equal(got, tq.q4_matmul_stream(
        x, w.values, w.scales, tile_n=tile_n, tile_k=tile_k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 9, 17])
def test_stream_matmul_widest_tile(dev, m, dtype):
    """tile_n 1024, the widest the card takes: 16 consumer warps, eight
    TMA boxes of 128 columns a stage."""
    g = torch.Generator(device=dev).manual_seed(m)
    w = tq.quantize_q4(torch.randn((1024, 2048), generator=g, device=dev),
                       64)
    x = torch.randn((m, 1024), generator=g, device=dev).to(dtype)
    got = tq.q4_matmul_stream(x, w.values, w.scales, tile_n=1024, tile_k=64)
    assert _rel_l2(got, tq.q4_matmul_stream_ref(x, w.values, w.scales)) < 1e-5
    assert torch.equal(got, tq.q4_matmul_stream(x, w.values, w.scales,
                                                tile_n=1024, tile_k=64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [5, 20])
def test_stream_matmul_nonfinite_rows(dev, m, dtype):
    """A NaN in the low half's activations and a +Inf and a -Inf in the
    high half's: NaN and Inf land where the plain version puts them, and
    the finite rows agree with it."""
    g = torch.Generator(device=dev).manual_seed(m)
    w = tq.quantize_q4(torch.randn((1024, 320), generator=g, device=dev),
                       256)
    x = torch.randn((m, 1024), generator=g, device=dev).to(dtype)
    x[0, 3] = float("nan")
    x[2, 512 + 7] = float("inf")
    x[3, 1023] = -float("inf")
    got = tq.q4_matmul_stream(x, w.values, w.scales)
    ref = tq.q4_matmul_stream_ref(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    assert torch.equal(got[torch.isinf(got)], ref[torch.isinf(ref)])
    bad = (~torch.isfinite(got)).all(dim=1).tolist()
    assert bad == [True, False, True, True] + [False] * (m - 4)
    finite = [1] + list(range(4, m))
    assert _rel_l2(got[finite], ref[finite]) < 1e-5


@pytest.mark.parametrize("k,n", MISTRAL_SHAPES)
@pytest.mark.parametrize("m", [1, 8])
def test_stream_matmul_at_mistral_shapes(dev, k, n, m):
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    w = tq.quantize_q4(torch.randn((k, n), generator=g, device=dev) / k ** 0.5)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    assert _rel_l2(tq.q4_matmul_stream(x, w.values, w.scales),
                   tq.q4_matmul_stream_ref(x, w.values, w.scales)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_matmul_on_layer_views(dev, dtype):
    """A layer's view of a stacked weight (the model's layout) is read at
    its offset."""
    g = torch.Generator(device=dev).manual_seed(5)
    ws = [tq.quantize_q4(torch.randn((1024, 256), generator=g, device=dev))
          for _ in range(3)]
    values = torch.stack([w.values for w in ws])
    scales = torch.stack([w.scales for w in ws])
    x = torch.randn((1, 1024), generator=g, device=dev).to(dtype)
    for i, w in enumerate(ws):
        assert torch.equal(tq.q4_matmul_stream(x, values[i], scales[i]),
                           tq.q4_matmul_stream(x, w.values, w.scales))


def test_stream_matmul_refuses_bad_operands(dev):
    w = tq.quantize_q4(torch.randn((1024, 256), device=dev), 128)
    x = torch.ones((2, 1024), device=dev)
    with pytest.raises(TypeError):
        tq.q4_matmul_stream(x.half(), w.values, w.scales)
    with pytest.raises(ValueError):     # weights on another device
        tq.q4_matmul_stream(x, w.values.cpu(), w.scales.cpu())
    with pytest.raises(ValueError):     # tile_n not a power of two
        tq.q4_matmul_stream(x, w.values, w.scales, tile_n=96)
    buf = torch.zeros(1 + w.values.numel(), dtype=torch.uint8, device=dev)
    shifted = buf[1:].view_as(w.values)
    shifted.copy_(w.values)
    with pytest.raises(ValueError):     # packed not 16-byte aligned
        tq.q4_matmul_stream(x, shifted, w.scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_matmul_in_a_cuda_graph(dev, dtype):
    """Captured once and replayed, as the overhead tool runs it: the replay
    gives the eager bits, and only the warm-up and capture count."""
    g = torch.Generator(device=dev).manual_seed(6)
    w = tq.quantize_q4(torch.randn((4096, 4096), generator=g, device=dev)
                       / 64.0)
    x = torch.randn((1, 4096), generator=g, device=dev).to(dtype)
    before = tq.q4_matmul_stream.launches
    replay = capture(lambda: tq.q4_matmul_stream(
        x, w.values, w.scales, tile_n=64, tile_k=1024), dev)
    assert tq.q4_matmul_stream.launches == before + 3
    out = replay()
    torch.cuda.synchronize()
    assert tq.q4_matmul_stream.launches == before + 3
    assert torch.equal(out, tq.q4_matmul_stream(x, w.values, w.scales,
                                                tile_n=64, tile_k=1024))


@pytest.mark.parametrize("shape", [(1, 16), (3, 1000), (64, 4096),
                                   (4096, 4096)])
def test_stream_probe_is_exact(dev, shape):
    """The kernel sums bytes as integers: exactly the int64 sum, converted
    once; the plain f32 sum is within its tolerance."""
    g = torch.Generator(device=dev).manual_seed(shape[0])
    w = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.uint8)
    x = torch.randn((1, 1), generator=g, device=dev)
    before = td.stream.launches
    got = td.stream(x, w)
    torch.cuda.synchronize()
    assert td.stream.launches == before + 1
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert torch.equal(got, w.to(torch.int64).sum().float() * x)
    ref = td.stream_ref(x, w)
    assert ((got - ref).abs() / ref.abs()).item() < 1e-5


def test_tiny_probes_match_plain(dev):
    x = torch.randn(td.TILE, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    before = (td.grid64.launches, td.chain_tiny.launches)
    assert torch.equal(td.grid64(x), td.grid64_ref(x))
    assert torch.equal(td.chain_tiny(x), td.chain_tiny_ref(x))
    assert torch.equal(td.chain_tiny(x, 3), x + 1 + 1 + 1)
    assert (td.grid64.launches, td.chain_tiny.launches) == (
        before[0] + 1, before[1] + td.CHAIN + 3)


@pytest.mark.parametrize("steps", [1, td.GRID_STEPS])
def test_grid64_steps_are_exact(dev, steps):
    x = torch.randn(td.TILE, generator=torch.Generator(
        device=dev).manual_seed(steps), device=dev)
    before = td.grid64.launches
    assert torch.equal(td.grid64(x, steps), td.grid64_ref(x, steps))
    assert torch.equal(td.grid64(x[0, :5], steps), x[0, :5] + 1)
    assert td.grid64.launches == before + 2
    with pytest.raises(ValueError):
        td.grid64(torch.zeros((2, 1024), device=dev))


def test_grid64_in_a_cuda_graph(dev):
    x = torch.randn(td.TILE, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    replay = capture(lambda: td.grid64(x), dev)
    for _ in range(2):
        out = replay()
    torch.cuda.synchronize()
    assert torch.equal(out, td.grid64_ref(x))


def test_chain_tiny_in_a_cuda_graph(dev):
    x = torch.zeros(td.TILE, device=dev)
    replay = capture(lambda: td.chain_tiny(x), dev)
    for _ in range(2):
        out = replay()
    torch.cuda.synchronize()
    assert torch.equal(out, td.chain_tiny_ref(x))


@pytest.mark.parametrize("n", [1, 2, 3, 63, td.CHAIN])
def test_chain_tiny_is_exact_eager_and_in_a_graph(dev, n):
    """The one-call chain equals n plain adds bit for bit, eager and
    replayed from a CUDA graph (its launches after the first carry
    programmatic dependent launch); the count rises by n a call, at the
    warm-up and capture and never at a replay."""
    x = torch.randn(td.TILE, generator=torch.Generator(
        device=dev).manual_seed(n), device=dev) * 100.0
    before = td.chain_tiny.launches
    assert torch.equal(td.chain_tiny(x, n), td.chain_tiny_ref(x, n))
    assert td.chain_tiny.launches == before + n
    replay = capture(lambda: td.chain_tiny(x, n), dev)
    assert td.chain_tiny.launches == before + 4 * n
    for _ in range(2):
        out = replay()
    torch.cuda.synchronize()
    assert torch.equal(out, td.chain_tiny_ref(x, n))
    assert td.chain_tiny.launches == before + 4 * n


CHAIN_PROFILE_CHILD = """
import sys
import torch
from torch.profiler import ProfilerActivity, profile
from trackiellm_tpu_torch.ops import diag as td
x = torch.zeros(td.TILE, device="cuda")
td.chain_tiny(x)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    td.chain_tiny(x)
    torch.cuda.synchronize()
print(sum(e.count for e in prof.key_averages()
          if "add_one_kernel" in e.key and e.self_device_time_total > 0))
"""


def test_chain_tiny_profile_shows_every_launch(dev):
    """One call of the chain is CHAIN launches of add_one_kernel on the
    card, not one folded launch. The profile runs in a fresh process, as
    chip_smoke.py's profiles do: late in a long process (this file's
    whole run) the profiler dropped 2-3 of the 64 records, while the exact
    sums of ``test_chain_tiny_is_exact_eager_and_in_a_graph`` show every
    add ran."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", CHAIN_PROFILE_CHILD],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert int(out.stdout.split()[-1]) == td.CHAIN


def _w4a8(dev):
    w = tq.quantize_q4(torch.randn((512, 64), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev))
    return lambda y: tq.q4_matmul_w4a8(y, w.values, w.scales)


# name: (shape of x, the wrapper's call on the device)
STREAM_CASES = {
    "chain_tiny n=1": (td.TILE, lambda dev: lambda y: td.chain_tiny(y, 1)),
    "chain_tiny n=64": (td.TILE, lambda dev: td.chain_tiny),
    "grid64": (td.TILE, lambda dev: td.grid64),
    "q4_matmul_w4a8": ((1, 512), _w4a8),
}


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_wrappers_launch_on_the_current_stream(dev, name):
    """Under ``torch.cuda.stream(side)`` a wrapper's kernels land on side:
    side sleeps, then fills x, then the wrapper reads it. A launch on any
    other stream would run during the sleep and read the zeros."""
    shape, make = STREAM_CASES[name]
    kernel = make(dev)
    x = torch.zeros(shape, device=dev)
    from_zeros = kernel(x)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)   # ~0.1 s of cycles on side alone
        x.fill_(0.5)
        out = kernel(x)
    torch.cuda.synchronize()
    want = kernel(torch.full(shape, 0.5, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out, want) and not torch.equal(want, from_zeros)


# rel L2 of the card's bf16-cache route against the CPU's f32 route on the
# same bf16 values: the products are exact in f32 and only the f32 sums'
# order differs, but that can move a probability across a bf16 rounding
# (the reference rounds p to the cache's dtype), which moves the output by
# up to 2^-8 of p |v|: ~1e-4 measured from a few such flips, 1e-3 allowed.
CACHE_TOL = 1e-3


@pytest.mark.parametrize("kw", [{}, {"window": 40}, {"sinks": True}],
                         ids=["plain", "window", "sinks"])
@pytest.mark.parametrize("s", [64, 512])
def test_decode_attention_bf16_cache_matches_the_cpu_route(dev, s, kw):
    """Mistral's heads (H 32, Hk 8, D 128) over a bf16 cache: the card's
    bf16 products with f32 sums against the CPU's f32 copies."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((32, 128), generator=g, device=dev)
    kc = torch.randn((s, 8, 128), generator=g, device=dev).bfloat16()
    vc = torch.randn((s, 8, 128), generator=g, device=dev).bfloat16()
    kw = dict(kw)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((32,), generator=g, device=dev)
    got = ta.decode_attention(q, kc, vc, s - 3, **kw)
    ref = ta.decode_attention(
        q.cpu(), kc.cpu(), vc.cpu(), s - 3,
        **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel_l2(got.cpu(), ref) < CACHE_TOL


def _extend_both(dev, s, window):
    """extend of a 16-token chunk (11 valid) after 20 cached rows, on a tiny
    f32 model with a bf16 cache, on the card and on the CPU."""
    cfg = llm.LLMConfig.tiny()._replace(max_seq=s,
                                        sliding_window=window or s)
    p_gpu = llm.init_params(torch.Generator(device=dev).manual_seed(s), cfg,
                            dtype=torch.float32, device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    cache = llm.KVCache.create(cfg, torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(s + 1)
    cache.k[:, :20] = torch.randn(cache.k[:, :20].shape, generator=g,
                                  device=dev).bfloat16()
    cache.v[:, :20] = torch.randn(cache.v[:, :20].shape, generator=g,
                                  device=dev).bfloat16()
    cache = cache._replace(length=20)
    cache_cpu = llm.KVCache(cache.k.cpu(), cache.v.cpu(), 20)
    chunk = torch.from_numpy(np.random.default_rng(s).integers(0, 256, 16))
    lg, _ = llm.extend(p_gpu, cfg, chunk.to(dev), 11, cache)
    lc, _ = llm.extend(p_cpu, cfg, chunk, 11, cache_cpu)
    return cfg, p_gpu, cache, chunk, lg, lc


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("s", [64, 512])
def test_extend_bf16_cache_matches_the_cpu_route(dev, s, window):
    *_, lg, lc = _extend_both(dev, s, window)
    assert torch.isfinite(lg).all()
    assert _rel_l2(lg.cpu(), lc) < CACHE_TOL


COPIES = ("aten::_to_copy", "aten::copy_", "aten::clone", "aten::contiguous")


def _cache_copies(fn, view_shape):
    """The ops of ``fn`` that copy a tensor of the cache view's size (in any
    order of its dims), from a profile that records input shapes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    want = sorted(view_shape)
    return [(e.name, e.input_shapes) for e in prof.events()
            if e.name in COPIES
            and any(sorted(sh) == want for sh in e.input_shapes if sh)]


def test_decode_and_extend_read_the_cache_without_a_copy(dev):
    """No cast or copy of the (S, Hk, D) cache view, nor of its transposed
    views, in decode attention or in extend on the card; the CPU route
    widens the same view to f32, which the profile sees."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((32, 128), generator=g, device=dev)
    kc = torch.randn((512, 8, 128), generator=g, device=dev).bfloat16()
    vc = torch.randn((512, 8, 128), generator=g, device=dev).bfloat16()
    assert _cache_copies(lambda: ta.decode_attention(q, kc, vc, 300),
                         kc.shape) == []
    assert _cache_copies(lambda: ta.decode_attention(
        q.cpu(), kc.cpu(), vc.cpu(), 300), kc.shape) != []
    cfg, params, cache, chunk, *_ = _extend_both(dev, 64, 0)
    view = cache.k.shape[1:]
    assert _cache_copies(lambda: llm.extend(params, cfg, chunk.to(dev), 11,
                                            cache), view) == []


def test_wrappers_raise_without_a_kernel_library(dev, monkeypatch, tmp_path):
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    q = torch.zeros((2, 64, 64), device=dev)
    with pytest.raises(_build.KernelBuildError):
        ta.flash_attention(q, q, q)
    w = tq.quantize_q4(torch.ones((512, 64), device=dev))
    x = torch.ones((1, 512), device=dev)
    with pytest.raises(_build.KernelBuildError):
        tq.q4_matmul_w4a8(x, w.values, w.scales)
    with pytest.raises(_build.KernelBuildError):
        tq.q4_matmul_f32a(x, w.values, w.scales)
    with pytest.raises(_build.KernelBuildError):
        tq.q4_matmul_stream(x, w.values, w.scales)
    with pytest.raises(_build.KernelBuildError):
        td.stream(torch.ones((1, 1), device=dev),
                  torch.ones((64, 64), dtype=torch.uint8, device=dev))
    tile = torch.ones(td.TILE, device=dev)
    with pytest.raises(_build.KernelBuildError):
        td.grid64(tile)
    with pytest.raises(_build.KernelBuildError):
        td.chain_tiny(tile)
    w8 = tq.quantize_q8(torch.ones((512, 64), device=dev))
    with pytest.raises(_build.KernelBuildError):
        tq.q8_matmul(x, w8.values, w8.scales)
    w_gu = tq.quantize_q4(torch.ones((512, 512), device=dev), 64)
    w_down = tq.quantize_q4(torch.ones((256, 512), device=dev), 64)
    with pytest.raises(_build.KernelBuildError):
        tf.fused_mlp_q4(x, torch.ones((512,), device=dev), w_gu.values,
                        w_gu.scales, w_down.values, w_down.scales)


def test_int8_kv_cells_give_the_cpu_bytes(dev):
    """The paged pool's int8 cells quantized on the card equal the CPU's
    (and so the JAX package's) bit for bit: the scale divides by a device
    tensor, not a Python number."""
    from trackiellm_tpu_torch.llm import paging
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 3, 128, 8, 128), generator=g) * 3.0
    q_cpu, s_cpu = paging._quant_cells(x)
    q_dev, s_dev = paging._quant_cells(x.to(dev))
    assert torch.equal(q_dev.cpu(), q_cpu)
    assert torch.equal(s_dev.cpu().view(torch.int32), s_cpu.view(torch.int32))


@pytest.mark.parametrize("window", [0, 100])
def test_batched_decode_attention_on_the_card(dev, window):
    """The serving slots' decode attention on the card (one product over
    each row's whole cache, the head diagonal kept) against each row's own
    decode_attention on the card and against the CPU route, with no copy
    of the (B, S, Hk, D) cache."""
    g = torch.Generator(device=dev).manual_seed(window)
    b, s = 8, 512
    q = torch.randn((b, 32, 128), generator=g, device=dev).bfloat16()
    kc = torch.randn((b, s, 8, 128), generator=g, device=dev).bfloat16()
    vc = torch.randn((b, s, 8, 128), generator=g, device=dev).bfloat16()
    lens = [1, 7, 64, 129, 300, 400, 511, 512]
    cur = torch.tensor(lens, device=dev)
    got = ta.decode_attention_batch(q, kc, vc, cur, window=window)
    for row, n in enumerate(lens):
        one = ta.decode_attention(q[row], kc[row], vc[row], n, window=window)
        assert _rel_l2(got[row], one) < 1e-2
    cpu = ta.decode_attention_batch(q.cpu(), kc.cpu(), vc.cpu(), cur.cpu(),
                                    window=window)
    assert _rel_l2(got.cpu(), cpu) < 1e-2
    assert _cache_copies(lambda: ta.decode_attention_batch(q, kc, vc, cur),
                         kc.shape) == []


def _tiny_served_params(dev):
    cfg = llm.LLMConfig.tiny()
    return cfg, llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(2), cfg, group=64,
        device=dev)


@pytest.mark.parametrize("paged", [False, True])
def test_server_chunks_give_the_per_step_ids_on_the_card(dev, paged):
    """A tiny Q4 model served on the card: pipelined 4-step chunks give
    every request the ids of the per-step loop, and the serve loop stays
    on the card."""
    from trackiellm_tpu_torch.llm import paging
    from trackiellm_tpu_torch.llm.server import LLMServer
    cfg, params = _tiny_served_params(dev)
    kw = dict(paged=True, page_size=16) if paged else {}
    got = {}
    for chunk in (1, 4):
        server = LLMServer(params, cfg, batch_slots=3, chunk_steps=chunk,
                           **kw)
        ids = {}
        finish = server._finish

        def record(slot, ids=ids, finish=finish):
            ids[slot.request.prompt] = list(slot.generated)
            finish(slot)
        server._finish = record
        try:
            futs = [server.submit(f"pergunta {i}", max_tokens=9 + 5 * i)
                    for i in range(5)]
            assert all(isinstance(f.result(timeout=120), str) for f in futs)
            assert server._fatal is None
            kv = (paging._pool_vals(server.pool.pool_k) if paged
                  else server.cache.k)
            assert kv.device.type == "cuda"
        finally:
            server.close()
        got[chunk] = ids
    assert got[1] == got[4] and len(got[1]) == 5


def test_server_sampled_requests_are_seeded_on_the_card(dev):
    """Sampled requests on the card (the server's CUDA generator): the same
    seed gives the same ids, and a 5x repetition penalty at near-greedy
    temperature keeps any token to at most 3 of 12."""
    from trackiellm_tpu_torch.llm.server import LLMServer
    cfg, params = _tiny_served_params(dev)

    def sampled(seed):
        server = LLMServer(params, cfg, batch_slots=1, seed=seed)
        try:
            server.submit("aaaa", max_tokens=12, temperature=0.01,
                          repetition_penalty=5.0).result(timeout=120)
            assert server._fatal is None
            return list(server._slots[0].generated)
        finally:
            server.close()
    first = sampled(3)
    assert first == sampled(3) and len(first) == 12
    assert max(first.count(t) for t in set(first)) <= 3


def test_int8_pool_serves_on_the_card(dev):
    """cache_dtype=int8 on the card: the pool's int8 values and f32 scales
    live on the card, requests complete on both paths, and every page
    comes back. (Chunks need not give the per-step ids here: a chunk
    reads its own new cells unquantized, as the reference's does.)"""
    from trackiellm_tpu_torch.llm.server import LLMServer
    cfg, params = _tiny_served_params(dev)
    for chunk in (1, 4):
        server = LLMServer(params, cfg, batch_slots=3, chunk_steps=chunk,
                           cache_dtype=torch.int8, page_size=16)
        try:
            pool = server.pool
            assert pool.quantized and pool.pool_k.vals.is_cuda
            assert pool.pool_k.vals.dtype == torch.int8
            assert pool.pool_k.scale.dtype == torch.float32
            futs = [server.submit(f"pergunta {i}", max_tokens=9 + 5 * i)
                    for i in range(5)]
            assert all(isinstance(f.result(timeout=120), str) for f in futs)
            assert server._fatal is None
            assert pool.free_pages == pool.n_pages - 1
        finally:
            server.close()


@pytest.mark.parametrize("make", ["pool", "cache", "batched", "vad",
                                  "silero"])
def test_allocators_default_to_the_card(dev, make):
    """With no device given, the page pool, both KV caches and the two VAD
    states allocate on the current CUDA card."""
    from trackiellm_tpu_torch.llm.paging import PagedKVPool
    from trackiellm_tpu_torch.models import vad
    cfg = llm.LLMConfig.tiny()
    if make == "pool":
        made = PagedKVPool(cfg, 8, 16)
        tensors = (made.pool_k, made.pool_v)
    elif make == "cache":
        made = llm.KVCache.create(cfg)
        tensors = (made.k, made.v)
    elif make == "batched":
        made = llm.BatchedKVCache.create(cfg, 2)
        tensors = (made.k, made.v, made.lengths)
    elif make == "vad":
        tensors = (vad.init_state(vad.VADConfig()),)
    else:
        tensors = vad.silero_init_state(vad.SileroConfig())
    assert all(t.device.type == "cuda" for t in tensors)


# ---------------------------------------------------------------------------
# The voice path on the card against the CPU
# ---------------------------------------------------------------------------

def _voice_audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    x = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (220.0, 440.0, 1330.0))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_voice_front_end_on_the_card(dev):
    from trackiellm_tpu_torch.ops import mel, resample, scan
    a = torch.from_numpy(_voice_audio(48_000))
    for n_mels in (80, 128):
        ref = mel.log_mel_spectrogram(a, n_mels=n_mels)
        got = mel.log_mel_spectrogram(a.to(dev), n_mels=n_mels)
        assert (got.cpu() - ref).abs().max().item() <= 1e-4
    for up, down in ((1, 3), (3, 1), (160, 441)):
        ref = resample.resample_poly(a, up, down)
        got = resample.resample_poly(a.to(dev), up, down)
        assert (got.cpu() - ref).abs().max().item() <= 1e-6
    x = torch.rand((3, 300), generator=torch.Generator().manual_seed(1)) * 4
    assert torch.equal(scan.cumsum(x.to(dev)).cpu(), scan.cumsum(x))


def test_vads_on_the_card(dev):
    """The neural VAD and Silero over 50 chunks, state carried: the card's
    probabilities within 1e-5 of the CPU's."""
    from trackiellm_tpu_torch.models import vad
    rng = np.random.default_rng(2)
    chunks = [torch.from_numpy((0.3 * rng.standard_normal(512))
                               .astype(np.float32)) for _ in range(50)]
    for init, init_state, step, cfg in (
            (vad.init_vad, vad.init_state, vad.vad_step, vad.VADConfig()),
            (vad.init_silero, vad.silero_init_state, vad.silero_step,
             vad.SileroConfig())):
        cpu = init(torch.Generator().manual_seed(3), cfg)
        card = llm.params_to(cpu, dev)
        sc, sg = init_state(cfg, "cpu"), init_state(cfg, dev)
        worst = 0.0
        for c in chunks:
            pc, sc = step(cpu, cfg, c, sc)
            pg, sg = step(card, cfg, c.to(dev), sg)
            worst = max(worst, abs(float(pc) - float(pg)))
        assert worst <= 1e-5


def _whisper_pair(dev, cfg=None):
    from trackiellm_tpu_torch.models import whisper
    cfg = cfg or whisper.WhisperConfig.test()
    cpu = whisper.init_whisper(torch.Generator().manual_seed(4), cfg)
    return whisper, cfg, cpu, llm.params_to(cpu, dev)


def test_whisper_on_the_card(dev):
    from trackiellm_tpu_torch.ops import mel
    whisper, cfg, cpu, card = _whisper_pair(dev)
    a = torch.from_numpy(_voice_audio(cfg.n_audio_ctx * 2 * 160, seed=5))
    m = mel.log_mel_spectrogram(a)
    fc = whisper.encode(cpu, cfg, m)
    fg = whisper.encode(card, cfg, m.to(dev))
    assert _rel_l2(fg.cpu(), fc) <= 1e-5
    cc = whisper.make_decoder_cache(cpu, cfg, fc)
    cg = whisper.make_decoder_cache(card, cfg, fg)
    for tok in (cfg.vocab_size - 2, 7, 200):
        lc, cc = whisper.decode_step(cpu, cfg, tok, cc)
        lg, cg = whisper.decode_step(card, cfg, tok, cg)
        assert _rel_l2(lg.cpu(), lc) <= 1e-5
    ids = whisper.transcribe_tokens(card, cfg, m.to(dev), max_tokens=20)
    assert ids == whisper.transcribe_tokens_host(card, cfg, m.to(dev),
                                                 max_tokens=20)


def test_voice_convolutions_ignore_the_tf32_flags(dev):
    """With TF32 allowed for cuDNN and cuBLAS, Whisper's front end (mel and
    the two convolutions into the encoder) and the TTS vocoder still match
    the CPU within 1e-5: their convolutions and matmuls run in full f32
    (``exact_f32``), and the caller's flags come back as they were."""
    from trackiellm_tpu_torch.models import tts
    from trackiellm_tpu_torch.ops import mel
    whisper, cfg, cpu, card = _whisper_pair(dev)
    tcfg = tts.TTSConfig.tiny()
    tcpu = tts.init_tts(torch.Generator().manual_seed(6), tcfg)
    tcard = llm.params_to(tcpu, dev)
    a = torch.from_numpy(_voice_audio(cfg.n_audio_ctx * 2 * 160, seed=6))
    melt = torch.randn((tcfg.max_frames, tcfg.n_mels),
                       generator=torch.Generator().manual_seed(7))
    ref_w = whisper.encode(cpu, cfg, mel.log_mel_spectrogram(a))
    ref_v = tts.vocoder_forward(tcpu, tcfg, melt)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got_w = whisper.encode(card, cfg,
                               mel.log_mel_spectrogram(a.to(dev)))
        got_v = tts.vocoder_forward(tcard, tcfg, melt.to(dev))
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert _rel_l2(got_w.cpu(), ref_w) <= 1e-5
    assert _rel_l2(got_v.cpu(), ref_v) <= 1e-5


def test_tts_on_the_card(dev):
    """TTS tiny: the card's mel and waveform against the CPU's with the
    frame counts equal, and the streamed chunks against the card's one-shot
    waveform (bit for bit, or within 1e-6 where cuBLAS sums a window in
    another order)."""
    from trackiellm_tpu_torch.models import tts
    cfg = tts.TTSConfig.tiny()
    cpu = tts.init_tts(torch.Generator().manual_seed(8), cfg)
    card = llm.params_to(cpu, dev)
    for text, rate in (("hello there streaming friend", 1.0),
                       ("uma xicara a frente.", 0.7)):
        ids, n = tts.text_to_ids(text, cfg.max_chars)
        ids = torch.from_numpy(ids.astype(np.int64))
        mc, nc = tts.acoustic_forward(cpu, cfg, ids, n, rate)
        mg, ng = tts.acoustic_forward(card, cfg, ids.to(dev), n, rate)
        assert int(ng) == int(nc)
        assert _rel_l2(mg.cpu(), mc) <= 1e-5
        wc, _ = tts.synthesize(cpu, cfg, text, rate)
        wg, _ = tts.synthesize(card, cfg, text, rate)
        assert len(wg) == len(wc)
        assert np.linalg.norm(wg - wc) / np.linalg.norm(wc) <= 1e-5
        streamed = np.concatenate(list(tts.synthesize_streaming(
            card, cfg, text, rate, chunk_frames=16, overlap=8)))
        assert len(streamed) == len(wg)
        assert np.abs(streamed - wg).max() <= 1e-6


def test_vits_on_the_card(dev):
    """VITS tiny with the CPU's noise: the card's waveform within 1e-4 of
    the CPU's, the frame counts equal."""
    from trackiellm_tpu_torch.models import vits
    cfg = vits.VITSConfig.tiny()
    cpu = vits.init_vits(torch.Generator().manual_seed(9), cfg)
    card = llm.params_to(cpu, dev)
    g = torch.Generator().manual_seed(10)
    nw = torch.randn((2, cfg.max_phonemes), generator=g)
    nz = torch.randn((cfg.d_model, cfg.max_frames), generator=g)
    ph = torch.zeros(cfg.max_phonemes, dtype=torch.long)
    ph[:12] = torch.arange(1, 13)
    for use_sdp in (True, False):
        wc, nc = vits.vits_infer(cpu, cfg, ph, 12, nw, nz, use_sdp=use_sdp)
        wg, ng = vits.vits_infer(card, cfg, ph.to(dev), 12, nw.to(dev),
                                 nz.to(dev), use_sdp=use_sdp)
        assert int(ng) == int(nc)
        assert _rel_l2(wg.cpu(), wc) <= 1e-4


# ---------------------------------------------------------------------------
# The vision path on the card against the CPU
# ---------------------------------------------------------------------------

def _tied_boxes(seed, anchors=8400, classes=80):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (anchors, 2)).astype(np.float32)
    boxes = np.concatenate(
        [xy, xy + rng.uniform(5, 120, (anchors, 2)).astype(np.float32)], 1)
    scores = (np.round(rng.uniform(0, 1, (anchors, classes)) * 8) / 8
              ).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("thresh", [0.5, 0.9, 2.0])
def test_nms_tie_order_on_the_card(dev, thresh, class_aware):
    """Thousands of anchors tie (at score 0 and at each eighth): the card
    keeps the reference's lower-index-first order, so its detections equal
    the CPU's bit for bit."""
    from trackiellm_tpu_torch.ops import nms
    boxes, scores = _tied_boxes(int(thresh * 10))
    kw = dict(score_thresh=thresh, max_out=20, class_aware=class_aware)
    ref = nms.decode_and_nms(boxes, scores, **kw)
    got = nms.decode_and_nms(boxes.to(dev), scores.to(dev), **kw)
    for name, r, g in zip(ref._fields, ref, got):
        assert torch.equal(g.cpu(), r), name
    v = torch.zeros(9000, device=dev)
    v[[5, 17, 4000]] = 0.5
    _, idx = nms.top_k_first_index(v, 256)
    assert idx[:4].tolist() == [5, 17, 4000, 0]
    assert idx.tolist()[3:] == sorted(idx.tolist()[3:])


def test_point_cloud_division_gives_the_cpu_bytes(dev):
    """z / fx divides by a 0-dim tensor on the card, not by a Python float
    (which CUDA torch turns into a product with the reciprocal): the
    points, the grid cells and the navigation grid are the CPU's bytes."""
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.navigation.path_planner import (
        draw_ransac_indices)
    from trackiellm_tpu_torch.ops import pointcloud as pc
    depth = torch.from_numpy((np.random.default_rng(3).random(
        (384, 384)) * 9.7 + 0.3).astype(np.float32))
    ref = pc.depth_to_point_cloud(depth, 300.0, 300.0, 192.0, 192.0)
    got = pc.depth_to_point_cloud(depth.to(dev), 300.0, 300.0, 192.0, 192.0)
    assert torch.equal(got.cpu(), ref)
    hc, cc = pc.points_to_height_grid(ref)
    hg, cg = pc.points_to_height_grid(got)
    assert torch.equal(cg.cpu(), cc) and torch.equal(hg.cpu(), hc)
    idx = draw_ransac_indices(torch.Generator().manual_seed(1), depth.numel())
    floor = depth.numpy().copy()
    floor[200:] = 300.0 / np.maximum(np.arange(200, 384) - 192.0, 1.0)[:, None]
    card = NavigationEngine(device=dev)
    cpu = NavigationEngine(device="cpu")
    np.testing.assert_array_equal(card.update(floor, indices=idx),
                                  cpu.update(floor, indices=idx))
    assert card.inlier_frac == cpu.inlier_frac
    np.testing.assert_array_equal(card.plane, cpu.plane)


def _vision_pair(dev, init, cfg, seed):
    cpu = init(torch.Generator().manual_seed(seed), cfg)
    return cpu, llm.params_to(cpu, dev)


@pytest.mark.parametrize("which", ["v8n", "v5nu"])
def test_detector_on_the_card(dev, which):
    from trackiellm_tpu_torch.models import detector
    cfg = getattr(detector.DetectorConfig, which)()
    cpu, card = _vision_pair(dev, detector.init_detector, cfg, 11)
    x = torch.rand((3, 640, 640), generator=torch.Generator().manual_seed(1))
    bc, pc_ = detector.detector_forward(cpu, cfg, x)
    bg, pg = detector.detector_forward(card, cfg, x.to(dev))
    assert bg.shape == (8400, 4) and pg.shape == (8400, 80)
    assert _rel_l2(bg.cpu(), bc) <= 1e-5 and _rel_l2(pg.cpu(), pc_) <= 1e-5


@pytest.mark.parametrize("which", ["midas", "dpt"])
def test_depth_models_on_the_card(dev, which):
    from trackiellm_tpu_torch.models import depth, dpt
    if which == "midas":
        cfg, init, fwd, s, tol = (depth.DepthConfig.small(), depth.init_depth,
                                  depth.depth_forward, 384, 1e-5)
    else:
        cfg, init, fwd, s, tol = (dpt.DPTSwinConfig.tiny_256(), dpt.init_dpt,
                                  dpt.dpt_forward, 256, 1e-4)
    cpu, card = _vision_pair(dev, init, cfg, 12)
    x = torch.randn((3, s, s), generator=torch.Generator().manual_seed(2))
    ref = fwd(cpu, cfg, x)
    got = fwd(card, cfg, x.to(dev))
    assert got.shape == (s, s) and _rel_l2(got.cpu(), ref) <= tol


def test_vision_convolutions_ignore_the_tf32_flags(dev):
    """Every vision forward runs under exact_f32: with the TF32 flags on,
    the detector still gives its f32 outputs."""
    from trackiellm_tpu_torch.models import detector
    cfg = detector.DetectorConfig.tiny()
    cpu, card = _vision_pair(dev, detector.init_detector, cfg, 13)
    x = torch.rand((3, 160, 160), generator=torch.Generator().manual_seed(3))
    ref = detector.detector_forward(cpu, cfg, x)[1]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got = detector.detector_forward(card, cfg, x.to(dev))[1]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert _rel_l2(got.cpu(), ref) <= 1e-5


def test_process_frame_on_the_card_sets_every_bit(dev):
    """VisionPipeline at tiny widths on the card, every analysis asked for:
    every valid bit set. Both sides detect from the CPU detector's raw
    outputs (random weights put scores within an ulp of each other, so the
    card's own raw outputs may order two detections the other way); then
    the card's objects, boxes, attributes, edges and texts are the CPU
    pipeline's."""
    from trackiellm_tpu_torch.models import depth, detector, ocr
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.ops import preprocess
    from trackiellm_tpu_torch.vision import (AnalysisFlags, VisionConfig,
                                             VisionPipeline)
    dcfg, pcfg, ocfg = (detector.DetectorConfig.tiny(),
                        depth.DepthConfig.tiny(), ocr.OCRConfig.tiny())
    params = {k: _vision_pair(dev, init, c, 20 + i) for i, (k, init, c) in
              enumerate((("det", detector.init_detector, dcfg),
                         ("dep", depth.init_depth, pcfg),
                         ("ocr", ocr.init_ocr, ocfg)))}
    frame = np.random.default_rng(4).integers(0, 256, (120, 160, 3),
                                              np.uint8)
    chw, _ = preprocess.letterbox_preprocess(torch.from_numpy(frame), 160,
                                             160)
    raw = detector.detector_forward(params["det"][0], dcfg, chw)

    def pipe(side, device):
        p = {k: v[side] for k, v in params.items()}
        return VisionPipeline(
            lambda chw: tuple(t.to(device) for t in raw),
            lambda chw: depth.depth_forward(p["dep"], pcfg, chw),
            lambda crops: ocr.ctc_greedy_decode(ocr.ocr_forward(
                p["ocr"], ocfg, torch.from_numpy(crops).to(device))),
            config=VisionConfig(detector_input=160, depth_input=96),
            navigation_engine=NavigationEngine(device=device), device=device)
    rg = pipe(1, dev).process_frame(frame, AnalysisFlags.ALL)
    rc = pipe(0, torch.device("cpu")).process_frame(frame, AnalysisFlags.ALL)
    assert rg.valid_analyses == AnalysisFlags.ALL == rc.valid_analyses
    assert rg.objects and len(rg.objects) == len(rc.objects)
    for a, b in zip(rg.objects, rc.objects):
        assert (a.class_id, a.attributes, a.text) == (b.class_id,
                                                      b.attributes, b.text)
        assert a.box == b.box
        assert a.distance_m == pytest.approx(b.distance_m, abs=1e-4)
    assert rg.full_text == rc.full_text
    assert rg.scene_graph["edges"] == rc.scene_graph["edges"]


def _qr_frame(seed, hw=(120, 160)):
    """A seeded noise frame with a QR code drawn on it."""
    from trackiellm_tpu_torch.vision import qr_decode
    frame = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    code = qr_decode.render_qr(qr_decode.encode_qr("SAIDA 2", version=1),
                               module_px=3)
    frame[4:4 + code.shape[0], 4:4 + code.shape[1]] = code[..., None]
    return frame


def test_process_frame_reads_a_frame_on_the_card(dev):
    """The camera worker hands the pipeline frames already on the card:
    process_frame(ALL) on such a tensor gives what the same frame as numpy
    gives (every bit, the objects, the texts and the barcodes), each
    through a fresh pipeline on the card. The OCR stage once fetched the
    frame with np.asarray, which raises on a CUDA tensor, and dropped its
    bit."""
    import dataclasses

    from trackiellm_tpu_torch.models import depth, detector, ocr
    from trackiellm_tpu_torch.navigation import NavigationEngine
    from trackiellm_tpu_torch.vision import (AnalysisFlags, VisionConfig,
                                             VisionPipeline)
    from trackiellm_tpu_torch.vision.qr import QRFinderDetector
    dcfg, pcfg, ocfg = (detector.DetectorConfig.tiny(),
                        depth.DepthConfig.tiny(), ocr.OCRConfig.tiny())
    p = {k: _vision_pair(dev, init, c, 30 + i)[1] for i, (k, init, c) in
         enumerate((("det", detector.init_detector, dcfg),
                    ("dep", depth.init_depth, pcfg),
                    ("ocr", ocr.init_ocr, ocfg)))}
    frame = _qr_frame(5)

    def run(f):
        pipe = VisionPipeline(
            lambda chw: detector.detector_forward(p["det"], dcfg, chw),
            lambda chw: depth.depth_forward(p["dep"], pcfg, chw),
            lambda crops: ocr.ctc_greedy_decode(ocr.ocr_forward(
                p["ocr"], ocfg, torch.from_numpy(crops).to(dev))),
            config=VisionConfig(detector_input=160, depth_input=96),
            barcode_fn=QRFinderDetector(),
            navigation_engine=NavigationEngine(device=dev), device=dev)
        r = pipe.process_frame(f, AnalysisFlags.ALL)
        return (r.valid_analyses,
                [dataclasses.asdict(o) for o in r.objects],
                [dataclasses.asdict(t) for t in r.text_regions],
                r.full_text, r.barcodes, r.navigation_cues)
    want = run(frame)
    got = run(torch.from_numpy(frame).to(dev))
    assert want[0] == AnalysisFlags.ALL and want[4]
    assert got == want


def _wake_clips(seed, n=16):
    """Two-tone keyword-like phrases and imposters (reversed, one tone,
    noise, near silence), as the wake word's trainer makes them."""
    rng = np.random.default_rng(seed)
    size = 76 * 160 + 240
    t = np.arange(size // 2) / 16_000

    def pair(f1, f2):
        a = 0.1 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6.28))
        b = 0.1 * np.sin(2 * np.pi * f2 * t + rng.uniform(0, 6.28))
        return (np.concatenate([a, b])
                + 0.02 * rng.standard_normal(size)).astype(np.float32)
    out = []
    for i in range(n // 2):
        out.append(pair(600.0, 1100.0))
        out.append([pair(1100.0, 600.0), pair(850.0, 850.0),
                    (0.1 * rng.standard_normal(size)).astype(np.float32),
                    (0.001 * rng.standard_normal(size)).astype(np.float32)
                    ][i % 4])
    return out


def test_wake_word_on_the_card(dev):
    """The bundled trained wake word on the card against the CPU: scores
    within 1e-5 through each side's log-mel, the same decisions, and the
    streaming detector fires on the same chunks."""
    from trackiellm_tpu_torch.audio import wake_word as ww
    from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram
    card = ww.load_default_wake_word(device=dev)
    cpu = ww.load_default_wake_word(device="cpu")
    assert card.params["conv1"]["w"].is_cuda
    cfg = card.cfg
    clips = _wake_clips(7)
    for clip in clips:
        s = [float(ww.wake_word_score(d.params, cfg, log_mel_spectrogram(
            torch.from_numpy(clip).to(d.device), n_mels=40)[:, -76:]))
            for d in (card, cpu)]
        assert abs(s[0] - s[1]) <= 1e-5
        assert (s[0] >= cfg.sensitivity) == (s[1] >= cfg.sensitivity)
    stream = np.concatenate(clips)
    fired = [[d(stream[i:i + 1600]) for i in range(0, len(stream), 1600)]
             for d in (card, cpu)]
    assert fired[0] == fired[1] and any(fired[0])


def test_camera_worker_uploads_frames_to_the_card(dev):
    """vision_worker puts each captured frame on the card before the
    cortex sees it; the bytes are the camera's."""
    import threading

    from trackiellm_tpu_torch.runtime import workers

    frames, got = [], []
    stop = threading.Event()
    camera = workers.mock_camera_source(64, 48)

    def shoot():
        frames.append(camera())
        return frames[-1]

    class Cortex:
        def inject_video_frame(self, f):
            got.append(f)
            if len(got) == 3:
                stop.set()
    t = threading.Thread(target=workers.vision_worker,
                         args=(stop, Cortex(), shoot), kwargs={"fps": 100.0})
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive() and len(got) == 3
    for f, g in zip(frames, got):
        assert g.is_cuda and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.cpu().numpy(), f)


def test_feeder_and_scheduler_on_the_card(dev):
    """DoubleBufferedFeeder stages on the card (newest first); a scheduler
    job that returns a card tensor is waited for, and its value is the
    job's."""
    from trackiellm_tpu_torch.runtime import (DoubleBufferedFeeder,
                                              InferenceScheduler, JobKind)
    f = DoubleBufferedFeeder(depth=2)
    for i in range(3):
        f.put(np.full((4, 4), float(i), np.float32))
    out = f.get(timeout=1.0)
    assert out.is_cuda and float(out[0, 0]) == 2.0 and f.dropped == 2
    s = InferenceScheduler()
    try:
        x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
        res = s.run(JobKind.VISION, lambda: (x * 2).sum())
        assert res.is_cuda and float(res) == float(x.sum() * 2)
    finally:
        s.close()


# -- the MoE families ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["w4a8", "f32a", "q8"])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_group32_kernels_at_gpt_oss_expert_shape(dev, kind, m):
    """gpt-oss's expert projections: K = 2880 (K/2 = 1440, 45 groups of 32
    a half) into N = 5760, at decode and prefill rows."""
    g = torch.Generator(device=dev).manual_seed(m)
    w32 = torch.randn((2880, 5760), generator=g, device=dev) / 2880 ** 0.5
    x = torch.randn((m, 2880), generator=g, device=dev).to(torch.bfloat16)
    if kind == "q8":
        w = tq.quantize_q8(w32, 32)
        got = tq.q8_matmul(x, w.values, w.scales)
        ref = tq.q8_matmul_ref(x, w.values, w.scales)
    else:
        w = tq.quantize_q4(w32, 32)
        kernel, plain = ((tq.q4_matmul_w4a8, tq.q4_matmul_w4a8_ref)
                         if kind == "w4a8" else
                         (tq.q4_matmul_f32a, tq.q4_matmul_f32a_ref))
        got = kernel(x, w.values, w.scales)
        ref = plain(x, w.values, w.scales)
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) < 1e-5


def test_w4a8_at_the_gpt_oss_vocabulary(dev):
    """lm_head of gpt-oss: N = 201,088 at group 32, one decode row."""
    g = torch.Generator(device=dev).manual_seed(1)
    w = tq.quantize_q4(torch.randn((2880, 201088), generator=g, device=dev)
                       / 2880 ** 0.5, 32)
    x = torch.randn((1, 2880), generator=g, device=dev).to(torch.bfloat16)
    got = tq.q4_matmul_w4a8(x, w.values, w.scales)
    assert _rel_l2(got, tq.q4_matmul_w4a8_ref(x, w.values, w.scales)) < 1e-5


@pytest.mark.parametrize("window", [0, 128])
def test_flash_sinks_at_gpt_oss_heads(dev, window):
    """(64, 8) heads at D = 64 with sinks, S = 512, bf16, causal."""
    g = torch.Generator(device=dev).manual_seed(window)
    q = torch.randn((64, 512, 64), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((8, 512, 64), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((8, 512, 64), generator=g, device=dev).to(torch.bfloat16)
    sinks = torch.randn((64,), generator=g, device=dev)
    got = ta.flash_attention(q, k, v, window=window, sinks=sinks)
    ref = ta.attention_ref(q, k, v, window=window, sinks=sinks)
    assert _rel_l2(got, ref) < 1e-2


def test_top_k_first_gives_the_cpu_ids_on_the_card(dev):
    """The router's top-k on the card: ties to the lower id and +0.0 above
    -0.0, as on the CPU (and ``lax.top_k``)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (64, 32), generator=g).float()
    x[torch.rand(x.shape, generator=g) < 0.3] = -0.0
    for k in (1, 4, 8):
        assert torch.equal(llm._top_k_first(x.to(dev), k).cpu(),
                           llm._top_k_first(x, k))


def _moe_tiny(name, **kw):
    c = getattr(llm.LLMConfig, name)()
    return c._replace(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, head_dim=64, hidden_dim=256,
                      n_experts=8, n_experts_used=min(c.n_experts_used, 4),
                      moe_shared_hidden=256 if c.moe_shared_hidden else 0,
                      max_seq=512, sliding_window=min(c.sliding_window, 512),
                      nope_pattern=2 if c.nope_pattern else 0,
                      attn_chunk=64 if c.attn_chunk else 0, **kw)


@pytest.mark.parametrize("name", ["gpt_oss_20b", "llama4_scout",
                                  "qwen15_moe_a27b"])
def test_moe_prefill_on_the_card_matches_the_cpu(dev, name):
    """A 2-layer MoE in f32 (dense weights) at bucket 256, card against CPU:
    the same routes' math in f32 sums of another order (gpt-oss's sinks on
    flash at D = 64, Llama-4's chunks on the dense path)."""
    cfg = _moe_tiny(name)
    p = llm.init_params(torch.Generator().manual_seed(3), cfg,
                        dtype=torch.float32, device="cpu")
    toks = torch.randint(0, 512, (256,),
                         generator=torch.Generator().manual_seed(4))
    outs = []
    for device in (dev, torch.device("cpu")):
        cache = llm.KVCache.create(cfg, torch.float32, device=device)
        outs.append(llm.prefill(llm.params_to(p, device), cfg,
                                toks.to(device), 200, cache)[0].cpu())
    assert _rel_l2(outs[0], outs[1]) < 1e-4


def test_moe_quantized_decode_launches_per_expert(dev):
    """Quantized expert banks take dense-all-experts on the card: a decode
    step of a 2-layer, 8-expert Q4 model launches W4A8 (and its quantizer)
    twice an expert a layer besides attention's four, and its logits are
    finite."""
    cfg = _moe_tiny("mixtral_8x7b")
    p = llm.init_params_quantized(torch.Generator(device=dev).manual_seed(0),
                                  cfg, group=128, device=dev)
    cache = llm.KVCache.create(cfg, device=dev)
    _, cache = llm.prefill(p, cfg, torch.arange(64, device=dev), 10, cache)
    before = tq.q4_matmul_w4a8.launches
    logits, _ = llm.decode_step(p, cfg, 5, cache)
    torch.cuda.synchronize()
    per_layer = 2 + 2 * cfg.n_experts      # wqkv, wo, each expert's two
    assert tq.q4_matmul_w4a8.launches - before == (
        cfg.n_layers * per_layer + 1)      # + lm_head
    assert torch.isfinite(logits).all()


# --- the multimodal path's shapes (chip_smoke.py phases 3 and 18) ----------

@pytest.mark.parametrize("kind,k,n,group,m", [
    ("w4a8", 2048, 257216, 256, 1),      # PaliGemma's lm_head
    ("w4a8", 16384, 2048, 256, 1),       # PaliGemma's w_down
    ("w4a8", 16384, 2048, 256, 512),
    ("f32a", 4096, 22016, 128, 1024),    # LLaVA-1.5-7B's w_gu
    ("f32a", 11008, 4096, 128, 1024),    # and w_down
    ("f32a", 11008, 4096, 128, 2048),
])
def test_multimodal_matmul_shapes_match_plain(dev, kind, k, n, group, m):
    """W4A8 and f32a at the multimodal models' shapes against their plain
    versions (rel L2 1e-5: the same products, f32 sums in another
    order)."""
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    w = tq.quantize_q4(torch.randn((k, n), generator=g, device=dev)
                       / k ** 0.5, group)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    kernel, plain = ((tq.q4_matmul_w4a8, tq.q4_matmul_w4a8_ref)
                     if kind == "w4a8"
                     else (tq.q4_matmul_f32a, tq.q4_matmul_f32a_ref))
    got = kernel(x, w.values, w.scales)
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert _rel_l2(got, plain(x, w.values, w.scales)) < 1e-5


def test_flash_at_llava_heads(dev):
    """Flash at LLaVA-1.5-7B's (32, 32) heads, D = 128, S = 1024, bf16,
    causal, against the plain version (rel L2 1e-2)."""
    g = torch.Generator(device=dev).manual_seed(1024)
    q, k, v = (torch.randn((32, 1024, 128), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    assert _rel_l2(ta.flash_attention(q, k, v),
                   ta.attention_ref(q, k, v)) < 1e-2


def test_llava_spliced_prefill_on_the_card_matches_cpu(dev):
    """LLaVA-1.5-7B's text model at its widths cut to 2 layers, Q4 at group
    128: a bucket-1024 prefill with image rows spliced over 576 of its
    rows (f32a and flash on the card) against the CPU's plain route (rel
    L2 2e-2: the same function, f32 sums in another order and bf16 flash),
    and an extend of the rolled-back tail."""
    cfg = llm.LLMConfig(vocab_size=32064, dim=4096, n_layers=2, n_heads=32,
                        n_kv_heads=32, head_dim=128, hidden_dim=11008,
                        max_seq=2048, sliding_window=2048)
    p_gpu = llm.init_params_quantized(
        torch.Generator(device=dev).manual_seed(0), cfg, group=128,
        device=dev)
    p_cpu = llm.params_to(p_gpu, torch.device("cpu"))
    toks = torch.randint(0, 32064, (1024,),
                         generator=torch.Generator().manual_seed(1))
    feats = torch.randn((576, 4096), generator=torch.Generator().manual_seed(2))
    out = []
    for params, device in ((p_gpu, dev), (p_cpu, torch.device("cpu"))):
        x = llm.embed_tokens(params, toks.to(device))
        x[100:676] = feats.to(device, x.dtype)
        before = tq.q4_matmul_f32a.launches
        lg, cache = llm.prefill(params, cfg, toks.to(device), 1000,
                                llm.KVCache.create(cfg, device=device),
                                embeds=x)
        cache = cache._replace(length=100)
        le, _ = llm.extend(params, cfg, toks[100:1124 - 100].to(device), 900,
                           cache, embeds=x[100:1024])
        out.append((lg.cpu(), le.cpu(), tq.q4_matmul_f32a.launches - before))
    (lg, le, f32a), (lc, lec, _) = out
    assert f32a > 0
    assert _rel_l2(lg, lc) < 2e-2 and _rel_l2(le, lec) < 2e-2


def test_vlm_digest_of_a_card_frame(dev):
    """A frame on the card and its bytes as numpy give one digest, and the
    card frame is encoded where it lies."""
    from trackiellm_tpu_torch.llm.vlm import VLMRunner
    frame = np.random.default_rng(0).integers(0, 256, (480, 640, 3),
                                              dtype=np.uint8)
    card = torch.from_numpy(frame).to(dev)
    assert VLMRunner._digest(card) == VLMRunner._digest(frame)
