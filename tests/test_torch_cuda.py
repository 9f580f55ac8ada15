"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports no JAX, so it runs on a host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX.)
"""

import numpy as np
import pytest
import torch

from trackiellm_tpu_torch.llm.runner import GenerationConfig, LLMRunner
from trackiellm_tpu_torch.models import llm
from trackiellm_tpu_torch.ops import _build
from trackiellm_tpu_torch.ops import attention as ta
from trackiellm_tpu_torch.ops import quant as tq

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
@pytest.mark.parametrize("d", [64, 128])
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
@pytest.mark.parametrize("group", [64, 256])
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


def test_w4a8_kernel_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = tq.quantize_q4(torch.randn((4096, 4096), generator=g, device=dev))
    x = torch.randn((1, 4096), generator=g, device=dev)
    a = tq.q4_matmul_w4a8(x, w.values, w.scales)
    b = tq.q4_matmul_w4a8(x, w.values, w.scales)
    assert torch.equal(a, b)


def test_quantized_matmul_dispatch_on_the_card(dev):
    w = tq.quantize_q4(torch.randn((512, 256), device=dev), 64)
    before = tq.q4_matmul_w4a8.launches
    tq.quantized_matmul(torch.randn((2, 3, 512), device=dev), w)
    assert tq.q4_matmul_w4a8.launches == before + 1
    big = tq.quantized_matmul(torch.randn((513, 512), device=dev), w)
    assert tq.q4_matmul_w4a8.launches == before + 1  # M > 512: dequant route
    assert big.shape == (513, 256)
    q8 = tq.quantize_q8(torch.randn((512, 256), device=dev), 64)
    with pytest.raises(NotImplementedError):
        tq.quantized_matmul(torch.randn((2, 512), device=dev), q8)


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
                            llm.KVCache.create(cfg, torch.float32))
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
    with pytest.raises(_build.KernelBuildError):
        tq.q4_matmul_w4a8(torch.ones((1, 512), device=dev), w.values,
                          w.scales)
