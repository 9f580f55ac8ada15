"""Decoder-only transformers, dense and mixture-of-experts, in PyTorch.

Port of ``trackiellm_tpu/models/llm.py``: Mistral, Llama-3.x, Qwen2/3,
Phi-3, Granite, GLM-4, Gemma-2/3, OLMo-2, SmolLM3, the GGUF-only Command-R,
Nemotron and StarCoder2 knob sets, and the expert families: Mixtral,
Qwen1.5/2-MoE, Qwen3-MoE, gpt-oss, Llama-4, GLM-4-MoE and Falcon. RMS or
LayerNorm (with an optional bias, pre-norms, sandwich or post-only
placement), split-half rotary embeddings (partial rotary, static or longrope
factors, Gemma-3's dual base, NoPE layers), grouped-query attention with
per-layer sliding windows, a query scale, a softcap, gpt-oss's sinks and
Llama-4's chunks, post-rope L2 norm and NoPE temperature, QK norms, gated or
plain MLPs (SwiGLU, GeGLU, gpt-oss's clamped SwiGLU, GELU, squared ReLU)
with biases, the MoE block (softmax, sigmoid and top-k-first routers, group
limits, shared experts, input-scaled experts; dense-all-experts on quantized
banks, sorted grouped products on bf16 ones), Granite's residual
multiplier, Command-R's and Falcon's parallel residuals and the final logit
softcap. Q4/Q8 group-quantized or dense weights, a KV cache in the
reference's (L, S_max, Hk, D) layout, and the batched serving functions
(``prefill_batch``, ``BatchedKVCache``, ``insert_sequence``,
``decode_step_batch``, ``decode_steps_batch``) that ``llm/server.py`` and
``llm/paging.py`` drive.

Parameters keep the JAX pytree layout (stacked ``(L, ...)`` layer tensors,
``(L, E, ...)`` expert banks, fused ``wqkv`` and ``w_gu``, LayerNorms with a
bias as ``{"g", "b"}`` dicts), so ``models/bridge.py`` maps the JAX
package's params onto these byte for byte. The reference's ``lax.scan`` over
layers is a Python loop over per-layer views of the stacked tensors, so each
layer's window, chunk, rope, norms and dense-or-MoE choice are made on the
host.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops import fused
from trackiellm_tpu_torch.ops.attention import (
    NEG_INF,
    cache_mix,
    cache_scores,
    decode_attention,
    decode_attention_batch,
    prefill_attention,
)
from trackiellm_tpu_torch.ops.backend import default_device, exact_f32, is_cuda
from trackiellm_tpu_torch.ops.quant import (
    QuantizedLinear,
    quantize_q4,
    quantize_q8,
    quantized_matmul,
)


class LLMConfig(NamedTuple):
    """Field names and defaults of ``trackiellm_tpu.models.llm.LLMConfig``,
    so ``LLMConfig(**jax_cfg._asdict())`` works; the knobs are documented
    there. Every knob set runs (:func:`check_supported` checks only the
    head counts)."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    hidden_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq: int = 4096
    sliding_window: int = 4096
    qkv_bias: bool = False
    act: str = "silu"
    post_norms: bool = False
    pre_norms: bool = True
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0
    residual_multiplier: float = 1.0
    partial_rotary_factor: float = 1.0
    qk_l2norm: bool = False
    attn_temp_tuning: bool = False
    attn_temp_floor: float = 8192.0
    attn_temp_scale: float = 0.1
    attn_chunk: int = 0
    moe_scale_input: bool = False
    moe_pattern: int = 0
    moe_first_dense: int = 0
    norm_type: str = "rms"
    parallel_residual: bool = False
    parallel_mlp_norm: bool = False
    mlp_gated: bool = True
    mlp_bias: bool = False
    alt_window: bool = False
    window_pattern: int = 0
    rope_local_theta: float = 0.0
    nope_pattern: int = 0
    rope_original_max_seq: int = 0
    rope_attention_factor: float = 1.0
    n_experts: int = 0
    n_experts_used: int = 2
    moe_norm_topk: bool = True
    moe_shared_hidden: int = 0
    qk_norm: bool = False
    qk_norm_full: bool = False
    moe_routed_scale: float = 1.0
    moe_shared_gated: bool = True
    moe_n_groups: int = 1
    moe_topk_groups: int = 1
    moe_score_func: str = "softmax"
    moe_group_score: str = "max"
    attn_sinks: bool = False
    out_bias: bool = False
    moe_bias: bool = False
    act_limit: float = 7.0

    @classmethod
    def mistral_7b(cls) -> "LLMConfig":
        return cls()

    @classmethod
    def llama3_8b(cls) -> "LLMConfig":
        """Llama-3-8B; Llama-3.1's rope scaling rides in as
        ``params["rope_factors"]`` (:func:`llama3_rope_factors`)."""
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=14336,
                   rope_theta=500000.0, max_seq=8192, sliding_window=8192)

    @classmethod
    def qwen2_7b(cls) -> "LLMConfig":
        return cls(vocab_size=152064, dim=3584, n_layers=28, n_heads=28,
                   n_kv_heads=4, head_dim=128, hidden_dim=18944,
                   rope_theta=1e6, max_seq=8192, sliding_window=8192,
                   qkv_bias=True)

    @classmethod
    def phi3_mini(cls) -> "LLMConfig":
        """Phi-3-mini-4k; the 128k longrope variants ride in as
        ``rope_factors_short``/``rope_factors_long`` params and
        ``rope_original_max_seq``."""
        return cls(vocab_size=32064, dim=3072, n_layers=32, n_heads=32,
                   n_kv_heads=32, head_dim=96, hidden_dim=8192,
                   rope_theta=10000.0, max_seq=4096,
                   sliding_window=2047)

    @classmethod
    def granite3_8b(cls) -> "LLMConfig":
        return cls(vocab_size=49155, dim=4096, n_layers=40, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=12800,
                   rope_theta=1e7, max_seq=8192, sliding_window=8192,
                   residual_multiplier=0.22,
                   query_pre_attn_scalar=float(128 ** 2))

    @classmethod
    def glm4_9b(cls) -> "LLMConfig":
        return cls(vocab_size=151552, dim=4096, n_layers=40, n_heads=32,
                   n_kv_heads=2, head_dim=128, hidden_dim=13696,
                   rope_theta=10000.0, max_seq=8192, sliding_window=8192,
                   qkv_bias=True, post_norms=True,
                   partial_rotary_factor=0.5)

    @classmethod
    def gemma2_2b(cls) -> "LLMConfig":
        return cls(vocab_size=256000, dim=2304, n_layers=26, n_heads=8,
                   n_kv_heads=4, head_dim=256, hidden_dim=9216,
                   norm_eps=1e-6, rope_theta=10000.0, max_seq=8192,
                   sliding_window=4096, act="gelu", post_norms=True,
                   attn_softcap=50.0, logit_softcap=30.0,
                   query_pre_attn_scalar=256.0, alt_window=True)

    @classmethod
    def gemma2_9b(cls) -> "LLMConfig":
        return cls(vocab_size=256000, dim=3584, n_layers=42, n_heads=16,
                   n_kv_heads=8, head_dim=256, hidden_dim=14336,
                   norm_eps=1e-6, rope_theta=10000.0, max_seq=8192,
                   sliding_window=4096, act="gelu", post_norms=True,
                   attn_softcap=50.0, logit_softcap=30.0,
                   query_pre_attn_scalar=256.0, alt_window=True)

    @classmethod
    def gemma3_1b(cls) -> "LLMConfig":
        return cls(vocab_size=262144, dim=1152, n_layers=26, n_heads=4,
                   n_kv_heads=1, head_dim=256, hidden_dim=6912,
                   norm_eps=1e-6, rope_theta=1e6, max_seq=32768,
                   sliding_window=512, act="gelu", post_norms=True,
                   query_pre_attn_scalar=256.0, qk_norm=True,
                   window_pattern=6, rope_local_theta=10000.0)

    @classmethod
    def gemma3_4b(cls) -> "LLMConfig":
        """Gemma-3-4B (text tower); pair with
        ``params["rope_factors"] = linear_rope_factors(cfg, 8.0)``."""
        return cls(vocab_size=262208, dim=2560, n_layers=34, n_heads=8,
                   n_kv_heads=4, head_dim=256, hidden_dim=10240,
                   norm_eps=1e-6, rope_theta=1e6, max_seq=131072,
                   sliding_window=1024, act="gelu", post_norms=True,
                   query_pre_attn_scalar=256.0, qk_norm=True,
                   window_pattern=6, rope_local_theta=10000.0)

    @classmethod
    def gemma3_12b(cls) -> "LLMConfig":
        return cls.gemma3_4b()._replace(
            dim=3840, n_layers=48, n_heads=16, n_kv_heads=8,
            hidden_dim=15360)

    @classmethod
    def gemma3_27b(cls) -> "LLMConfig":
        return cls.gemma3_4b()._replace(
            dim=5376, n_layers=62, n_heads=32, n_kv_heads=16,
            head_dim=128, hidden_dim=21504,
            query_pre_attn_scalar=168.0)

    @classmethod
    def olmo2_7b(cls) -> "LLMConfig":
        return cls(vocab_size=100352, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=32, head_dim=128, hidden_dim=11008,
                   norm_eps=1e-6, rope_theta=500000.0, max_seq=4096,
                   sliding_window=4096, pre_norms=False, post_norms=True,
                   qk_norm_full=True)

    @classmethod
    def smollm3_3b(cls) -> "LLMConfig":
        return cls(vocab_size=128256, dim=2048, n_layers=36, n_heads=16,
                   n_kv_heads=4, head_dim=128, hidden_dim=11008,
                   norm_eps=1e-6, rope_theta=5e6, max_seq=65536,
                   sliding_window=65536, nope_pattern=4)

    @classmethod
    def qwen3_8b(cls) -> "LLMConfig":
        return cls(vocab_size=151936, dim=4096, n_layers=36, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=12288,
                   norm_eps=1e-6, rope_theta=1e6, max_seq=32768,
                   sliding_window=32768, qk_norm=True)

    @classmethod
    def mixtral_8x7b(cls) -> "LLMConfig":
        """Mixtral-8x7B: Mistral's attention, 8 experts top-2."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=14336,
                   rope_theta=1e6, max_seq=8192, sliding_window=8192,
                   n_experts=8, n_experts_used=2)

    @classmethod
    def qwen15_moe_a27b(cls) -> "LLMConfig":
        """Qwen1.5-MoE-A2.7B: 60 experts top-4 (not renormalized) and a
        gated 5632-wide shared expert."""
        return cls(vocab_size=151936, dim=2048, n_layers=24, n_heads=16,
                   n_kv_heads=16, head_dim=128, hidden_dim=1408,
                   rope_theta=1e6, max_seq=8192, sliding_window=8192,
                   qkv_bias=True, n_experts=60, n_experts_used=4,
                   moe_norm_topk=False, moe_shared_hidden=5632)

    @classmethod
    def qwen3_moe_30b_a3b(cls) -> "LLMConfig":
        """Qwen3-30B-A3B: 128 experts top-8 (renormalized), QK norms."""
        return cls(vocab_size=151936, dim=2048, n_layers=48, n_heads=32,
                   n_kv_heads=4, head_dim=128, hidden_dim=768,
                   norm_eps=1e-6, rope_theta=1e6, max_seq=32768,
                   sliding_window=32768, qk_norm=True, n_experts=128,
                   n_experts_used=8, moe_norm_topk=True)

    @classmethod
    def gpt_oss_20b(cls) -> "LLMConfig":
        """gpt-oss-20b: 32 experts top-4, (64, 8) heads at D = 64, sinks,
        attention and expert biases, clamped SwiGLU, window 128 on even
        layers; pair with ``yarn_rope_factors(cfg, 32.0, 4096,
        truncate=False)`` (the YaRN attention factor is set here)."""
        return cls(vocab_size=201088, dim=2880, n_layers=24, n_heads=64,
                   n_kv_heads=8, head_dim=64, hidden_dim=2880,
                   rope_theta=150000.0, max_seq=131072, sliding_window=128,
                   alt_window=True, n_experts=32, n_experts_used=4,
                   moe_score_func="softmax_topk", moe_norm_topk=False,
                   moe_bias=True, attn_sinks=True, qkv_bias=True,
                   out_bias=True, act="gptoss",
                   rope_attention_factor=yarn_attention_factor(32.0))

    @classmethod
    def gpt_oss_120b(cls) -> "LLMConfig":
        return cls.gpt_oss_20b()._replace(n_layers=36, n_experts=128)

    @classmethod
    def llama4_scout(cls) -> "LLMConfig":
        """Llama-4-Scout-17B-16E (text tower): 16 experts top-1 with
        input-scaled sigmoid routing and an ungated shared expert, NoPE
        every 4th layer with temperature tuning, post-rope QK L2 norm and
        8192-chunk attention on the rope layers."""
        return cls(vocab_size=202048, dim=5120, n_layers=48, n_heads=40,
                   n_kv_heads=8, head_dim=128, hidden_dim=8192,
                   rope_theta=500000.0, max_seq=8192, sliding_window=8192,
                   n_experts=16, n_experts_used=1,
                   moe_score_func="sigmoid_topk", moe_norm_topk=False,
                   moe_scale_input=True, moe_shared_hidden=8192,
                   moe_shared_gated=False, nope_pattern=4, qk_l2norm=True,
                   attn_temp_tuning=True, attn_chunk=8192)

    @classmethod
    def tiny(cls) -> "LLMConfig":
        """Small config for tests."""
        return cls(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                   n_kv_heads=2, head_dim=64, hidden_dim=512, max_seq=256,
                   sliding_window=256)


# The dense presets, by their JAX package names.
DENSE_PRESETS = ("mistral_7b", "llama3_8b", "qwen2_7b", "phi3_mini",
                 "granite3_8b", "glm4_9b", "gemma2_2b", "gemma2_9b",
                 "gemma3_1b", "gemma3_4b", "gemma3_12b", "gemma3_27b",
                 "olmo2_7b", "smollm3_3b", "qwen3_8b")
# The expert presets (and gpt-oss's and Llama-4's attention knobs).
MOE_PRESETS = ("mixtral_8x7b", "qwen15_moe_a27b", "qwen3_moe_30b_a3b",
               "gpt_oss_20b", "gpt_oss_120b", "llama4_scout")


def check_supported(cfg: LLMConfig,
                    params: Optional[Dict[str, Any]] = None) -> None:
    """Every knob set of the JAX package runs; the head counts must group
    (GQA)."""
    del params
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError("n_heads must be a multiple of n_kv_heads")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _is_hybrid(cfg: LLMConfig) -> bool:
    """Dense and MoE layers interleave (Llama-4 Maverick's pattern, the
    leading dense layers of GLM-4-MoE and ERNIE-4.5)."""
    return bool(cfg.n_experts) and (cfg.moe_pattern > 1
                                    or cfg.moe_first_dense > 0)


def _is_moe_layer(cfg: LLMConfig, li: int) -> bool:
    """Layer ``li`` runs the MoE block (the reference's ``_mlp``)."""
    if not _is_hybrid(cfg):
        return bool(cfg.n_experts)
    is_moe = li >= cfg.moe_first_dense
    if cfg.moe_pattern > 1:
        is_moe &= li % cfg.moe_pattern == cfg.moe_pattern - 1
    return is_moe


def _matrices(cfg: LLMConfig) -> Dict[str, Tuple[Tuple[int, ...], int, int]]:
    """The quantizable matrices (the reference's ``_QUANTIZABLE``): name ->
    (leading dims, K, N); expert banks lead with (L, E)."""
    d, h, l = cfg.dim, cfg.hidden_dim, cfg.n_layers
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    out = {"wqkv": ((l,), d, qd + 2 * kvd), "wo": ((l,), qd, d)}
    if cfg.n_experts:
        e = cfg.n_experts
        out["w_gu"] = ((l, e), d, 2 * h)
        out["w_down"] = ((l, e), h, d)
        if cfg.moe_shared_hidden:
            hs = cfg.moe_shared_hidden
            out["shared_gu"] = ((l,), d, 2 * hs)
            out["shared_down"] = ((l,), hs, d)
    else:
        out["w_gu"] = ((l,), d, 2 * h if cfg.mlp_gated else h)
        out["w_down"] = ((l,), h, d)
    return out


def _family_leaves(cfg: LLMConfig, normal, dtype, device) -> Dict[str, Any]:
    """The per-layer leaves besides the quantizable matrices and the two
    pre-norms (the JAX package's ``init_params``): QKV and output biases,
    sinks, sandwich norms, QK norms, the MLP biases, the router and its
    biases, the shared expert's gate and a hybrid stack's dense MLP.
    ``normal(shape)`` gives f32 standard normals."""
    l, d, h = cfg.n_layers, cfg.dim, cfg.hidden_dim
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def small(*shape):
        return (normal(shape) * 0.02).to(dtype)

    def w(*shape):
        return (normal(shape) / math.sqrt(shape[-2])).to(dtype)
    out: Dict[str, Any] = {}
    if cfg.qkv_bias:
        out["wqkv_bias"] = small(l, qd + 2 * kvd)
    if cfg.post_norms:
        out["attn_post_norm"] = ones(l, d)
        out["mlp_post_norm"] = ones(l, d)
    if cfg.qk_norm:
        out["q_norm"] = ones(l, cfg.head_dim)
        out["k_norm"] = ones(l, cfg.head_dim)
    elif cfg.qk_norm_full:
        out["q_norm"] = ones(l, qd)
        out["k_norm"] = ones(l, kvd)
    if cfg.out_bias:
        out["wo_bias"] = small(l, d)
    if cfg.attn_sinks:
        out["attn_sink"] = normal((l, cfg.n_heads)) * 0.5
    if cfg.n_experts:
        e = cfg.n_experts
        out["moe_gate"] = w(l, d, e)
        if cfg.moe_bias:
            out["moe_gate_b"] = small(l, e)
            out["w_gu_b"] = small(l, e, 2 * h)
            out["w_down_b"] = small(l, e, d)
        if cfg.moe_shared_hidden:
            out["shared_gate"] = w(l, d, 1)
        if _is_hybrid(cfg):
            out["w_gu_mlp"] = w(l, d, 2 * h if cfg.mlp_gated else h)
            out["w_down_mlp"] = w(l, h, d)
    elif cfg.mlp_bias:
        out["w_gu_b"] = small(l, _matrices(cfg)["w_gu"][2])
        out["w_down_b"] = small(l, d)
    return out


def init_params(generator: torch.Generator, cfg: LLMConfig,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random params in the reference's layout (stacked layers, (L, E, K,
    N) expert banks), with the leaves the config's family reads.
    ``generator`` must live on ``device``."""
    check_supported(cfg)
    d, l = cfg.dim, cfg.n_layers

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def w(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2])
        return (normal(shape) * scale).to(dtype)

    layers = {"attn_norm": torch.ones((l, d), dtype=dtype, device=device),
              "mlp_norm": torch.ones((l, d), dtype=dtype, device=device)}
    for name, (lead, kk, nn) in _matrices(cfg).items():
        layers[name] = w(*lead, kk, nn)
    layers.update(_family_leaves(cfg, normal, dtype, device))
    return {
        "tok_emb": w(cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": w(d, cfg.vocab_size),
    }


def _quantize_stack(stacked: torch.Tensor, quantize,
                    group: int) -> QuantizedLinear:
    """Quantize every (K, N) matrix of an (..., K, N) stack, one at a
    time, into one QuantizedLinear with the same leading dims."""
    lead = stacked.shape[:-2]
    flat = stacked.reshape(-1, *stacked.shape[-2:])
    values = scales = None
    for i in range(flat.shape[0]):
        q = quantize(flat[i], group)
        if values is None:
            values = q.values.new_empty((flat.shape[0], *q.values.shape))
            scales = q.scales.new_empty((flat.shape[0], *q.scales.shape))
        values[i], scales[i] = q.values, q.scales
    return QuantizedLinear(values=values.reshape(*lead, *values.shape[1:]),
                           scales=scales.reshape(*lead, *scales.shape[1:]))


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    group: int = 256) -> Dict[str, Any]:
    """Quantize the per-layer matrices of ``_matrices`` that the tree holds
    (expert banks one expert at a time) and lm_head (Q4 or Q8);
    embeddings, norms, biases, the router, the shared expert's gate, a
    hybrid stack's dense MLP and rope factors keep their dtype."""
    quantize = quantize_q4 if bits == 4 else quantize_q8
    out = dict(params)
    layers = dict(params["layers"])
    for name in _QUANTIZABLE:
        if name in layers:
            layers[name] = _quantize_stack(layers[name], quantize, group)
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"], group)
    return out


_QUANTIZABLE = ("wqkv", "wo", "w_gu", "w_down", "shared_gu", "shared_down")


def init_params_quantized(generator: torch.Generator, cfg: LLMConfig,
                          bits: int = 4, group: int = 256,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Random params straight into quantized form, one (K, N) matrix (one
    expert's) at a time, so peak memory is one f32 matrix beside the
    quantized model; the layout of :func:`quantize_params` of
    :func:`init_params`. ``generator`` must live on ``device``."""
    check_supported(cfg)
    quantize = quantize_q4 if bits == 4 else quantize_q8
    d, l = cfg.dim, cfg.n_layers

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def build_one(kk, nn):
        return quantize(normal((kk, nn)) / math.sqrt(kk), group)

    layers: Dict[str, Any] = {
        "attn_norm": torch.ones((l, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((l, d), dtype=dtype, device=device),
    }
    for name, (lead, kk, nn) in _matrices(cfg).items():
        layers[name] = quantized_stack(lead, lambda: build_one(kk, nn))
    layers.update(_family_leaves(cfg, normal, dtype, device))
    tok_emb = (normal((cfg.vocab_size, d)) * 0.02).to(dtype)
    return {
        "tok_emb": tok_emb,
        "layers": layers,
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": build_one(d, cfg.vocab_size),
    }


def quantized_stack(lead: Tuple[int, ...], build) -> QuantizedLinear:
    """``prod(lead)`` matrices from ``build()`` (a QuantizedLinear each,
    made one at a time) stacked into one with leading dims ``lead``: peak
    memory is one float matrix beside the stack."""
    count = math.prod(lead)
    first = build()
    values = first.values.new_empty((count, *first.values.shape))
    scales = first.scales.new_empty((count, *first.scales.shape))
    values[0], scales[0] = first.values, first.scales
    for i in range(1, count):
        q = build()
        values[i], scales[i] = q.values, q.scales
    return QuantizedLinear(values=values.reshape(*lead, *first.values.shape),
                           scales=scales.reshape(*lead, *first.scales.shape))


def params_to(params: Any, device: torch.device) -> Any:
    """A copy of a param tree on ``device`` (None leaves and host values
    stay; named tuples, ``QuantizedLinear`` and ``models.lora.LoraLinear``,
    keep their type; a tensor-parallel wrapper keeps its mesh)."""
    if isinstance(params, TPLinear):
        return params._replace(w=params_to(params.w, device))
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if hasattr(params, "_fields"):
        return type(params)._make(params_to(v, device) for v in params)
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device) if isinstance(params, torch.Tensor) else params


def _layer(layers: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li``'s view of the stacked layer params (no copies); a
    LayerNorm's ``{"g", "b"}`` dict gives a dict of views."""
    return {name: _layer_leaf(w, li) for name, w in layers.items()}


def _layer_leaf(w, li: int):
    """Row ``li`` of one stacked leaf: of each field of a named tuple (a
    ``QuantizedLinear``, or a ``models.lora.LoraLinear`` with its base,
    adapters and per-layer alpha), of each entry of a dict, or of a
    tensor."""
    if isinstance(w, TPLinear):
        return w._replace(w=_layer_leaf(w.w, li))
    if hasattr(w, "_fields"):
        return type(w)._make(_layer_leaf(f, li) for f in w)
    if isinstance(w, dict):
        return _layer(w, li)
    return w[li]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, w) -> torch.Tensor:
    """Projection through a QuantizedLinear, a dense (K, N) weight or a
    LoRA-wrapped base (``models.lora.LoraLinear``, known by its fields), f32
    sums cast back to x's dtype. A dense bf16 weight on the card is read as
    it is stored, with f32 sums (``torch.mm(..., out_dtype=float32)``, the
    reference's ``preferred_element_type=f32``): an f32 copy of the weight
    would cost its traffic on every call. The CPU widens both to f32. The
    LoRA branch adds ``(x @ a) @ b * (alpha / r)`` in f32 torch ops to the
    base's output, as the reference computes it outside any kernel. A
    :class:`TPLinear` carries its shard's collective."""
    if isinstance(w, TPLinear):
        return _tp_linear(x, w)
    if hasattr(w, "base") and hasattr(w, "a"):
        y = _linear(x, w.base)
        r = w.a.shape[-1]
        delta = torch.matmul(torch.matmul(x.float(), w.a.float()),
                             w.b.float())
        return (y.float() + delta * (w.alpha / r)).to(x.dtype)
    return _linear_f32(x, w).to(x.dtype)


def _linear_f32(x: torch.Tensor, w) -> torch.Tensor:
    """The f32 product of x and a QuantizedLinear or dense (K, N) weight,
    before :func:`_linear`'s cast."""
    if isinstance(w, QuantizedLinear):
        return quantized_matmul(x, w)
    out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class TPLinear(NamedTuple):
    """One rank's shard of a projection under tensor parallelism
    (``parallel/infer.py:shard_params``), with the collective that makes
    its output the whole product on every rank of ``comm`` (the mesh):

    - ``"row"``: a K slice (row-parallel ``wo``, ``w_down``); the f32
      partial sums are all-reduced before the cast to x's dtype, so each
      rank's partial is never rounded on its own. ``pad`` zero columns are
      appended to x to meet zero K rows (whole zero quantization groups
      that make the packed shard's K fit the kernels).
    - ``"whole"``: the full matrix, kept where a K slice would cut a
      quantization group in two; x is all-gathered along K first.
    - ``"vocab"``: an N slice of ``lm_head``; the outputs are all-gathered
      along N (the logits of every row on every rank).

    Column-parallel projections (``wqkv``, ``w_gu``) need no collective:
    they stay plain leaves."""

    w: Any
    comm: Any
    kind: str
    pad: int = 0


def _tp_linear(x: torch.Tensor, w: TPLinear) -> torch.Tensor:
    if w.kind == "whole":
        return _linear(w.comm.all_gather(x, dim=-1), w.w)
    if w.kind == "vocab":
        return w.comm.all_gather(_linear(x, w.w), dim=-1)
    if w.pad:
        x = F.pad(x, (0, w.pad))
    return w.comm.all_reduce(_linear_f32(x, w.w)).to(x.dtype)


def _tp_degree(w) -> int:
    """The tp degree a row-parallel shard's mesh gives (1 elsewhere)."""
    return w.comm.tp if isinstance(w, TPLinear) else 1


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 sums and an f32 result
    (``preferred_element_type``): a bf16 pair on the card is read as
    stored; elsewhere both widen to f32. ``torch.mm(..., out_dtype=)`` has
    no derivative, so where autograd records the bf16 pair goes through
    :class:`_MmF32Fn`."""
    if is_cuda(a) and a.dtype == b.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MmF32Fn.apply(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MmF32Fn(torch.autograd.Function):
    """:func:`_mm_f32` on a bf16 pair with its gradients: f32 products of
    the f32 output gradient with each operand widened (TF32 off), cast to
    the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        da = db = None
        with exact_f32():
            if ctx.needs_input_grad[0]:
                da = torch.mm(dy, b.float().t()).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = torch.mm(a.float().t(), dy).to(b.dtype)
        return da, db


def _unit_rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMS normalization over the last axis, cast to x's dtype, with
    no weight. On the card it is PyTorch's fused RMS norm, which reduces
    each row in a block of its own: a row gets the same bits whether the
    call holds one row (a decode step) or sixteen (a verify pass), so
    greedy speculation keeps plain decode's ids. The unfused f32 mean's
    order depends on the row count there, and one flipped rounding of a
    norm can change a greedy token."""
    if is_cuda(x):
        return F.rms_norm(x, (x.shape[-1],), eps=eps)
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`_unit_rms`, then scaled."""
    return _unit_rms(x, eps) * scale


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 mean-subtracting norm over the last axis with the population
    variance, cast to x's dtype (no weight). On the card it is PyTorch's
    fused LayerNorm, a row's reduction in a block of its own, so a row's
    bits do not depend on the row count (as :func:`_rms_norm`)."""
    x32 = x.float()
    if is_cuda(x):
        return F.layer_norm(x32, (x.shape[-1],), eps=eps).to(x.dtype)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _norm(x: torch.Tensor, p, eps: float, kind: str = "rms") -> torch.Tensor:
    """The config's norm: ``p`` is a bare weight (RMS, or a LayerNorm
    without bias) or a ``{"g", "b"}`` dict (a LayerNorm with bias)."""
    if isinstance(p, dict):
        g, b = p["g"], p.get("b")
    else:
        g, b = p, None
    out = (_rms_norm(x, g, eps) if kind == "rms"
           else _layer_norm(x, eps) * g)
    return out + b if b is not None else out


def _qk_norm(q: torch.Tensor, k: torch.Tensor, layer,
             cfg: LLMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q/K norms before rope on (..., H, D) heads: per head (Qwen3, Gemma-3;
    a per-head LayerNorm under ``norm_type="layernorm"``, Command-R+), or
    over the whole projection (OLMo-2's ``qk_norm_full``)."""
    if cfg.qk_norm_full:
        def full(t, w):
            flat = t.reshape(*t.shape[:-2], -1)
            return _rms_norm(flat, w, cfg.norm_eps).reshape(t.shape)
        return full(q, layer["q_norm"]), full(k, layer["k_norm"])
    if not cfg.qk_norm:
        return q, k
    if cfg.norm_type == "layernorm":
        def ln(t, w):
            return _layer_norm(t, cfg.norm_eps) * w.reshape(t.shape[-2:])
        return ln(q, layer["q_norm"]), ln(k, layer["k_norm"])
    return (_rms_norm(q, layer["q_norm"], cfg.norm_eps),
            _rms_norm(k, layer["k_norm"], cfg.norm_eps))


def _attn_in(x: torch.Tensor, layer, cfg: LLMConfig) -> torch.Tensor:
    """The attention branch's input: the pre-normed residual stream, or
    the raw stream under OLMo-2's post-norm-only placement."""
    if not cfg.pre_norms:
        return x
    return _norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_type)


def _act_combine(gate: torch.Tensor, up: torch.Tensor, act: str = "silu",
                 limit: float = 7.0) -> torch.Tensor:
    """The gate/up halves of a GLU (f32 in and out): SwiGLU, GeGLU with the
    tanh approximation (``act="gelu"``, Gemma), or gpt-oss's clamped
    SwiGLU (``act="gptoss"``: gate clamped above at ``limit``, up to
    +-limit, ``(up + 1) * gate * sigmoid(1.702 gate)``)."""
    if act == "gptoss":
        gate = gate.clamp(max=limit)
        up = up.clamp(-limit, limit)
        return (up + 1.0) * (gate * torch.sigmoid(gate * 1.702))
    gated = (F.silu(gate) if act == "silu"
             else F.gelu(gate, approximate="tanh"))
    return gated * up


def _mlp_act(gu: torch.Tensor, act: str, gated: bool,
             limit: float = 7.0) -> torch.Tensor:
    """The MLP's activation on the f32 up projection: a GLU of its halves,
    or, ungated, squared ReLU (``relu2``, Nemotron), exact GELU
    (``gelu_exact``) or tanh GELU (StarCoder2)."""
    if gated:
        gate, up = gu.chunk(2, dim=-1)
        return _act_combine(gate, up, act, limit)
    if act == "relu2":
        return F.relu(gu).square()
    return F.gelu(gu, approximate="none" if act == "gelu_exact" else "tanh")


def _scaled(out: torch.Tensor, multiplier: float) -> torch.Tensor:
    """``out * multiplier`` with the multiplier rounded to out's dtype
    first, as the reference's ``jnp.asarray(multiplier, out.dtype)``."""
    if multiplier == 1.0:
        return out
    return out * _rounded(multiplier, out.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def _mlp_block(x: torch.Tensor, norm_scale, w_gu, w_down, eps: float,
               act: str = "silu", post_norm=None,
               residual_multiplier: float = 1.0, norm_type: str = "rms",
               gated: bool = True, w_gu_b=None, w_down_b=None
               ) -> torch.Tensor:
    """norm -> up -> act -> down (+ bias) [-> post-norm] [x multiplier] ->
    + residual. ``norm_scale`` None is OLMo-2's placement: the MLP reads
    the raw stream.

    Small-M Q4 weights take the one-launch fused block (``ops/fused.py``)
    behind the ``TRACKIE_FUSED_MLP=1`` opt-in, read at each call, under
    the JAX package's condition (``llm.py:764-768``): SwiGLU with an RMS
    pre-norm, no post-norm, multiplier 1, gated weights; decode and the
    lookahead chunk take it, prefill and extend (M > 8) and Q8 weights do
    not. The biases are not in the condition, as there: no dense preset
    has them with SwiGLU. A forward that autograd records does not take
    it: the fused kernel has no gradient."""
    if (x.dim() == 2 and act == "silu" and post_norm is None
            and norm_scale is not None and residual_multiplier == 1.0
            and gated and norm_type == "rms"
            and not isinstance(norm_scale, dict)
            and fused.use_fused_mlp() and fused._can_fuse(x, w_gu, w_down)
            and not (torch.is_grad_enabled() and x.requires_grad)):
        return fused.fused_mlp(x, norm_scale, w_gu, w_down, eps)
    h2 = _norm(x, norm_scale, eps, norm_type) if norm_scale is not None else x
    gu = _linear(h2, w_gu).float()
    if w_gu_b is not None:
        gu = gu + w_gu_b.float()
    out = _linear(_mlp_act(gu, act, gated).to(x.dtype), w_down)
    if w_down_b is not None:
        out = out + w_down_b
    if post_norm is not None:
        out = _norm(out, post_norm, eps, norm_type)
    return x + _scaled(out, residual_multiplier)


def _expert_slice(w, e: int):
    """Expert ``e`` of an (E, ...) bank (a tensor or a QuantizedLinear whose
    values and scales carry the expert axis): a view."""
    if isinstance(w, TPLinear):
        return w._replace(w=_expert_slice(w.w, e))
    if isinstance(w, QuantizedLinear):
        return QuantizedLinear(values=w.values[e], scales=w.scales[e])
    return w[e]


def _moe_use_routed(n_tokens: int, w_gu, tp: int = 1) -> bool:
    """The reference's dispatch between the two MoE formulations:
    quantized banks always take dense-all-experts; bf16 banks take the
    sorted grouped products when ``TRACKIE_MOE_ROUTED`` is "1", never when
    it is "0", and by default when the dense-all-experts MLP would cost at
    least 5e11 FLOPs (the reference's crossover, kept as its rule). A tp
    shard's bank holds 1/``tp`` of the columns: the rule reads the whole
    model's, so every rank and the single device choose alike."""
    if isinstance(w_gu, QuantizedLinear):
        return False
    mode = os.environ.get("TRACKIE_MOE_ROUTED", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    n_experts, d, n2 = w_gu.shape
    return 2 * n_tokens * n_experts * d * n2 * tp * 1.5 >= 5e11


def _grouped_dot(xs: torch.Tensor, bank: torch.Tensor,
                 sizes) -> torch.Tensor:
    """Rows [off_g, off_g + size_g) of ``xs`` times ``bank[g]`` for each
    group, f32 out: the reference's ``lax.ragged_dot``. ``sizes`` are host
    ints."""
    out = xs.new_empty((xs.shape[0], bank.shape[-1]), dtype=torch.float32)
    off = 0
    for g, size in enumerate(sizes):
        if size:
            out[off:off + size] = _mm_f32(xs[off:off + size], bank[g])
            off += size
    return out


def _moe_routed(h2: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor,
                layer, cfg: LLMConfig) -> torch.Tensor:
    """Dropless routed MoE on bf16 banks (the reference's ``_moe_routed``
    and, under ``moe_scale_input``, ``_moe_routed_scaled_in``): the (T *
    K) token slots stably sorted by expert, each expert's contiguous run
    through its bank, and the weighted outputs summed back per token.

    The reference scatter-adds into f32 zeros in sorted-slot order, which
    for a token is ascending expert order; the sum here follows that
    order from 0.0 through the inverted permutation (an atomic
    ``index_add_`` would make a row's bits depend on the other rows). The
    group sizes are read on the host, once a layer."""
    t, d = h2.shape
    k = cfg.n_experts_used
    flat = topi.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    src = order // k
    wts = topv.reshape(-1)[order]
    xs = h2[src]
    if cfg.moe_scale_input:
        xs = xs * wts[:, None].to(h2.dtype)
    sizes = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    biased = cfg.moe_bias and not cfg.moe_scale_input
    gu = _grouped_dot(xs, layer["w_gu"], sizes)
    if biased:
        gu = gu + layer["w_gu_b"][sorted_e].float()
    gate, up = gu.chunk(2, dim=-1)
    down = layer["w_down"]
    ys = _grouped_dot(
        _act_combine(gate, up, cfg.act, cfg.act_limit).to(h2.dtype),
        down.w if isinstance(down, TPLinear) else down, sizes)
    if isinstance(down, TPLinear):   # a row-parallel shard: f32 partials
        ys = down.comm.all_reduce(ys)
    if biased:
        ys = ys + layer["w_down_b"][sorted_e].float()
    if not cfg.moe_scale_input:
        ys = ys * wts[:, None]
    # Each token's sorted positions, ascending: its slots in expert order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    pos = torch.sort(inv.reshape(t, k), dim=-1).values
    out = torch.zeros((t, d), dtype=torch.float32, device=h2.device)
    for j in range(k):
        out = out + ys[pos[:, j]]
    return out


def _moe_shared(h2: torch.Tensor, layer, cfg: LLMConfig) -> torch.Tensor:
    """The always-active shared expert (Qwen-MoE's gated by
    sigmoid(shared_gate(h2)), Llama-4's and GLM-4-MoE's ungated), f32; f32
    zeros without one, the routed mixture's starting value."""
    if not cfg.moe_shared_hidden:
        return torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
    gu = _linear(h2, layer["shared_gu"]).float()
    gate, up = gu.chunk(2, dim=-1)
    y = _linear(_act_combine(gate, up, cfg.act, cfg.act_limit).to(h2.dtype),
                layer["shared_down"]).float()
    if not cfg.moe_shared_gated:
        return y
    g = torch.sigmoid(_linear(h2, layer["shared_gate"]).float())
    return g * y


def _top_k_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis in ``lax.top_k``'s
    order: the lower index first among equals, and +0.0 above -0.0 (its
    comparison is IEEE's total order). A stable descending sort of the
    total-order integer key of each f32 does both on the CPU and the card
    (``torch.topk`` promises neither; a float sort ties the zeros)."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _moe_select(h2: torch.Tensor, layer, cfg: LLMConfig):
    """The router's (T, E) f32 scores and the selection values its top-k
    reads: softmax or sigmoid scores, or (``*_topk``, gpt-oss and Llama-4)
    the raw logits; the router bias ``moe_gate_b`` shifts both, the
    selection-only ``moe_gate_bias`` only the selection; group-limited
    routing zeroes all but the ``moe_topk_groups`` best groups (by max or
    top-2 sum) of the selection."""
    logits = _linear(h2, layer["moe_gate"]).float()
    if cfg.moe_bias:
        logits = logits + layer["moe_gate_b"].float()
    if cfg.moe_score_func == "sigmoid":
        scores = torch.sigmoid(logits)
    elif cfg.moe_score_func in ("softmax_topk", "sigmoid_topk"):
        scores = logits
    else:
        scores = torch.softmax(logits, dim=-1)
    select = scores
    if "moe_gate_bias" in layer:
        select = scores + layer["moe_gate_bias"].float()
    if cfg.moe_n_groups > 1:
        t = select.shape[0]
        gsz = cfg.n_experts // cfg.moe_n_groups
        g = select.reshape(t, cfg.moe_n_groups, gsz)
        if cfg.moe_group_score == "top2sum":
            top2 = g.gather(-1, _top_k_first(g, 2))
            gscore = top2[..., 0] + top2[..., 1]
        else:
            gscore = g.amax(dim=-1)
        gtop = _top_k_first(gscore, cfg.moe_topk_groups)
        gmask = torch.zeros_like(gscore).scatter(-1, gtop, 1.0)
        select = select * gmask.repeat_interleave(gsz, dim=-1)
    return scores, select


def _moe_router(h2: torch.Tensor, layer, cfg: LLMConfig):
    """The router: (T, K) combine weights (f32) and expert ids, the top-k
    of :func:`_moe_select`'s selection weighted by :func:`_moe_weights`."""
    scores, select = _moe_select(h2, layer, cfg)
    topi = _top_k_first(select, cfg.n_experts_used)
    return _moe_weights(scores, topi, cfg), topi


def _moe_weights(scores: torch.Tensor, topi: torch.Tensor,
                 cfg: LLMConfig) -> torch.Tensor:
    """The (T, K) f32 combine weights of experts ``topi``: their scores,
    transformed under ``softmax_topk`` and ``sigmoid_topk``, then
    renormalized and scaled by ``moe_routed_scale``."""
    topv = scores.gather(-1, topi)
    if cfg.moe_score_func == "softmax_topk":
        topv = torch.softmax(topv, dim=-1)
    elif cfg.moe_score_func == "sigmoid_topk":
        topv = torch.sigmoid(topv)
    if cfg.moe_norm_topk:
        denom = topv.sum(dim=-1, keepdim=True)
        if cfg.moe_score_func == "sigmoid":
            denom = denom + 1e-20
        topv = topv / denom
    if cfg.moe_routed_scale != 1.0:
        topv = topv * cfg.moe_routed_scale
    return topv


def _moe_block(x: torch.Tensor, layer, cfg: LLMConfig) -> torch.Tensor:
    """norm -> router -> top-k experts (+ shared expert) [-> post-norm]
    [x multiplier] -> + residual, in the reference's two formulations:
    dense-all-experts (quantized banks, and bf16 ones below the routed
    rule), where every expert runs on every row, weighted by a (T, E)
    matrix that is zero off the top-k, summed in expert order from the
    shared expert's output; or :func:`_moe_routed`. Llama-4 scales each
    expert's input by its weight instead of its output."""
    h2 = _norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_type)
    topv, topi = _moe_router(h2, layer, cfg)
    if _moe_use_routed(x.shape[0], layer["w_gu"],
                       _tp_degree(layer["w_down"])):
        out = _moe_routed(h2, topv, topi, layer, cfg) + _moe_shared(
            h2, layer, cfg)
    else:
        weights = torch.zeros((x.shape[0], cfg.n_experts),
                              dtype=torch.float32, device=x.device)
        weights = weights.scatter(-1, topi, topv)
        out = _moe_shared(h2, layer, cfg)
        for e in range(cfg.n_experts):
            we = weights[:, e:e + 1]
            h2_e = h2 * we.to(h2.dtype) if cfg.moe_scale_input else h2
            gu = _linear(h2_e, _expert_slice(layer["w_gu"], e)).float()
            if cfg.moe_bias:
                gu = gu + layer["w_gu_b"][e].float()
            gate, up = gu.chunk(2, dim=-1)
            y = _linear(
                _act_combine(gate, up, cfg.act, cfg.act_limit).to(x.dtype),
                _expert_slice(layer["w_down"], e)).float()
            if cfg.moe_bias:
                y = y + layer["w_down_b"][e].float()
            out = out + (y if cfg.moe_scale_input else we * y)
    out = out.to(x.dtype)
    if cfg.post_norms:
        out = _norm(out, layer["mlp_post_norm"], cfg.norm_eps, cfg.norm_type)
    return x + _scaled(out, cfg.residual_multiplier)


def _mlp(x: torch.Tensor, layer, cfg: LLMConfig, li: int) -> torch.Tensor:
    """The MLP of every forward body: the MoE block on layer ``li`` of an
    expert config (:func:`_is_moe_layer`), else the dense MLP (a hybrid
    stack's from ``w_gu_mlp``/``w_down_mlp``, without biases)."""
    if _is_moe_layer(cfg, li):
        return _moe_block(x, layer, cfg)
    hybrid = _is_hybrid(cfg)
    return _mlp_block(
        x, layer["mlp_norm"] if cfg.pre_norms else None,
        layer["w_gu_mlp" if hybrid else "w_gu"],
        layer["w_down_mlp" if hybrid else "w_down"], cfg.norm_eps,
        act=cfg.act, post_norm=layer.get("mlp_post_norm"),
        residual_multiplier=cfg.residual_multiplier,
        norm_type=cfg.norm_type, gated=cfg.mlp_gated,
        w_gu_b=layer.get("w_gu_b") if cfg.mlp_bias and not hybrid else None,
        w_down_b=(layer.get("w_down_b") if cfg.mlp_bias and not hybrid
                  else None))


def _attn_residual(x: torch.Tensor, attn_out: torch.Tensor, layer,
                   cfg: LLMConfig) -> torch.Tensor:
    """wo projection (+ bias) [-> post-attention norm] [x multiplier] +
    residual."""
    out = _linear(attn_out.to(x.dtype), layer["wo"])
    if cfg.out_bias:
        out = out + layer["wo_bias"]
    if cfg.post_norms:
        out = _norm(out, layer["attn_post_norm"], cfg.norm_eps,
                    cfg.norm_type)
    return x + _scaled(out, cfg.residual_multiplier)


def _mlp_branch(h: torch.Tensor, layer, cfg: LLMConfig) -> torch.Tensor:
    """The MLP branch from an already-normed input (the parallel residual:
    no norm, no post-norm, no residual)."""
    gu = _linear(h, layer["w_gu"]).float()
    if cfg.mlp_bias and "w_gu_b" in layer:
        gu = gu + layer["w_gu_b"].float()
    out = _linear(_mlp_act(gu, cfg.act, cfg.mlp_gated,
                           cfg.act_limit).to(h.dtype), layer["w_down"])
    if cfg.mlp_bias and "w_down_b" in layer:
        out = out + layer["w_down_b"]
    return out


def _layer_tail(x, h, attn, layer, cfg: LLMConfig, li: int) -> torch.Tensor:
    """Everything after the attention weights: sequential residuals, or
    the parallel residual (x + attn + mlp): Command-R's MLP reads the
    attention's norm ``h``, Falcon's new architecture
    (``parallel_mlp_norm``) norms the stream itself."""
    if cfg.parallel_residual:
        out = _linear(attn.to(x.dtype), layer["wo"])
        if cfg.out_bias:
            out = out + layer["wo_bias"]
        hm = (_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_type)
              if cfg.parallel_mlp_norm else h)
        return x + out + _mlp_branch(hm, layer, cfg).to(x.dtype)
    return _mlp(_attn_residual(x, attn, layer, cfg), layer, cfg, li)


def _output_logits(params: Dict[str, Any], cfg: LLMConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """Final norm -> lm_head (-> logit softcap), f32."""
    h = _norm(x, params["out_norm"], cfg.norm_eps, cfg.norm_type)
    logits = _linear(h, params["lm_head"]).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Attention policy: scale, softcap and per-layer windows
# ---------------------------------------------------------------------------

def _attn_scale(cfg: LLMConfig) -> float:
    """1/sqrt(query_pre_attn_scalar or head_dim), times the longrope/YaRN
    attention factor squared."""
    base = 1.0 / math.sqrt(cfg.query_pre_attn_scalar or cfg.head_dim)
    return base * cfg.rope_attention_factor ** 2


def _layer_window(cfg: LLMConfig) -> int:
    return cfg.sliding_window if 0 < cfg.sliding_window < cfg.max_seq else 0


def _per_layer_windows(cfg: LLMConfig) -> bool:
    """True when the window applies to only some layers."""
    return cfg.alt_window or cfg.window_pattern > 1


def _is_sliding(cfg: LLMConfig, li: int) -> bool:
    """Layer ``li`` slides: Gemma-2 the even layers, Gemma-3 all but every
    ``window_pattern``-th."""
    if cfg.window_pattern > 1:
        return li % cfg.window_pattern != cfg.window_pattern - 1
    return li % 2 == 0


def _window_of(cfg: LLMConfig, li: int) -> int:
    """Layer ``li``'s window (0 = none): the config's window, except on a
    global layer of a per-layer pattern."""
    win = _layer_window(cfg)
    if win and _per_layer_windows(cfg) and not _is_sliding(cfg, li):
        return 0
    return win


def _chunk_of(cfg: LLMConfig, li: int) -> int:
    """Layer ``li``'s attention chunk (0 = none): Llama-4's rope layers
    attend within aligned chunks of ``attn_chunk``; NoPE layers are
    global."""
    if not cfg.attn_chunk or _is_nope(cfg, li):
        return 0
    return cfg.attn_chunk


def _attn_kw(cfg: LLMConfig, li: int, layer) -> dict:
    """Window, chunk, sinks, softcap and scale of layer ``li``'s prefill and
    decode attention (the reference's ``_prefill_attn``/``_decode_attn``):
    a chunked config attends with no window; gpt-oss's sinks are the
    layer's (H,) ``attn_sink``."""
    scale = _attn_scale(cfg)
    if not cfg.query_pre_attn_scalar and cfg.rope_attention_factor == 1.0:
        scale = 0.0   # the kernels' own 1/sqrt(head_dim)
    return {"softcap": cfg.attn_softcap, "scale": scale,
            "window": 0 if cfg.attn_chunk else _window_of(cfg, li),
            "chunk": _chunk_of(cfg, li),
            "sinks": layer["attn_sink"] if cfg.attn_sinks else None}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(cfg: LLMConfig, device=None) -> torch.Tensor:
    """The (rotary dims / 2,) f32 rope frequencies (partial rotary rotates
    ``partial_rotary_factor * head_dim`` dims), made once per (width,
    theta, device): building them copies theta to the device, which on the
    card waits for the stream."""
    half = int(cfg.head_dim * cfg.partial_rotary_factor) // 2
    return _rope_freqs_on(half, cfg.rope_theta,
                          None if device is None else torch.device(device))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(half: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, device=device), exps)


def _local_rope_freqs(cfg: LLMConfig, device=None) -> torch.Tensor:
    """Gemma-3's sliding-layer base, never scaled by rope factors."""
    return _rope_freqs(cfg._replace(rope_theta=cfg.rope_local_theta), device)


def _freqs(params: Dict[str, Any], cfg: LLMConfig, total_len,
           device=None) -> torch.Tensor:
    """Rope frequencies divided by the checkpoint's factors: the static
    ``rope_factors`` (Llama-3.1, linear, YaRN), or Phi-3's longrope sets,
    the long one when ``total_len`` (the length this dispatch reaches; a
    host int, or a device tensor, chosen on the device) exceeds
    ``rope_original_max_seq``."""
    freqs = _rope_freqs(cfg, device)
    if "rope_factors_short" in params:
        short, long = params["rope_factors_short"], params["rope_factors_long"]
        if isinstance(total_len, torch.Tensor):
            ext = torch.where(total_len > cfg.rope_original_max_seq, long,
                              short)
        else:
            ext = long if total_len > cfg.rope_original_max_seq else short
        return freqs / ext
    rf = params.get("rope_factors")
    return freqs / rf if rf is not None else freqs


def linear_rope_factors(cfg: LLMConfig, factor: float) -> torch.Tensor:
    """Uniform linear rope scaling as a divisor vector, f32 (head_dim / 2,)
    on the CPU; Gemma-3 4B+ store ``linear_rope_factors(cfg, 8.0)`` as
    ``params["rope_factors"]``."""
    return torch.full((cfg.head_dim // 2,), float(factor),
                      dtype=torch.float32)


def llama3_rope_factors(cfg: LLMConfig, factor: float = 8.0,
                        low_freq_factor: float = 1.0,
                        high_freq_factor: float = 4.0,
                        original_max_seq: int = 8192) -> torch.Tensor:
    """Llama-3.1's per-frequency rope divisors, f32 on the CPU: long
    wavelengths divide by ``factor``, short ones stay, the band between
    interpolates (``trackiellm_tpu/models/llm.py:llama3_rope_factors``).
    Store as ``params["rope_factors"]``."""
    freqs = _rope_freqs(cfg)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    wavelen = f32(2.0 * math.pi) / freqs
    low_wl = original_max_seq / low_freq_factor
    high_wl = original_max_seq / high_freq_factor
    smooth = ((f32(original_max_seq) / wavelen - low_freq_factor)
              / f32(high_freq_factor - low_freq_factor)).clamp(0.0, 1.0)
    inv = (1.0 - smooth) / f32(factor) + smooth
    return torch.where(wavelen > low_wl, f32(factor),
                       torch.where(wavelen < high_wl, f32(1.0), f32(1.0) / inv))


def yarn_rope_factors(cfg: LLMConfig, factor: float, original_max_seq: int,
                      beta_fast: float = 32.0, beta_slow: float = 1.0,
                      truncate: bool = True) -> torch.Tensor:
    """YaRN per-frequency rope divisors, f32 (head_dim / 2,) on the CPU
    (``trackiellm_tpu/models/llm.py:yarn_rope_factors``): dims with more
    than ``beta_fast`` rotations over the original context extrapolate
    (divisor 1), dims with fewer than ``beta_slow`` interpolate (divisor
    ``factor``), the band between blends linearly by dim index. Store as
    ``params["rope_factors"]`` with ``cfg.rope_attention_factor =
    yarn_attention_factor(factor)``."""
    half = cfg.head_dim // 2

    def corr_dim(n_rot: float) -> float:
        # The dim whose frequency completes n_rot rotations over the
        # original context: solve orig * freq_i = 2*pi*n_rot.
        return (cfg.head_dim
                * math.log(original_max_seq / (n_rot * 2.0 * math.pi))
                / (2.0 * math.log(cfg.rope_theta)))

    low_f, high_f = corr_dim(beta_fast), corr_dim(beta_slow)
    if truncate:
        low_f, high_f = math.floor(low_f), math.ceil(high_f)
    low = max(low_f, 0)
    high = min(high_f, cfg.head_dim - 1)
    if high == low:
        high += 0.001                    # transformers' singularity guard
    ramp = torch.clamp(
        (torch.arange(half, dtype=torch.float32) - low) / (high - low),
        0.0, 1.0)
    ext = 1.0 - ramp                     # 1 = extrapolate, 0 = interpolate
    return 1.0 / (ext + (1.0 - ext) / factor)


def yarn_attention_factor(factor: float) -> float:
    """YaRN mscale ``0.1 ln(s) + 1`` (``cfg.rope_attention_factor``)."""
    return 0.1 * math.log(factor) + 1.0 if factor > 1.0 else 1.0


def _rope_cos_sin(positions: torch.Tensor, freqs: torch.Tensor):
    ang = positions[..., :, None].float() * freqs              # (S, R/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Split-half rotation of the leading 2 * (R/2) dims of (..., H, D);
    the rest (partial rotary) pass through."""
    rot = 2 * cos.shape[-1]
    x1, x2 = x[..., :rot].float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=-1).to(x.dtype)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """Rotate (..., S, H, D) by per-position angles, split-half layout."""
    return _rotate(x, *_rope_cos_sin(positions, freqs))


def _is_nope(cfg: LLMConfig, li: int) -> bool:
    """Layer ``li`` applies no rotary embedding (SmolLM3's interval)."""
    return cfg.nope_pattern > 1 and li % cfg.nope_pattern == cfg.nope_pattern - 1


def _rope_tables(params, cfg: LLMConfig, positions: torch.Tensor,
                 total_len) -> Tuple[Any, Any]:
    """(cos, sin) of the global frequencies at ``positions``, and of
    Gemma-3's local base (None without ``rope_local_theta``)."""
    device = positions.device
    glob = _rope_cos_sin(positions, _freqs(params, cfg, total_len, device))
    local = (_rope_cos_sin(positions, _local_rope_freqs(cfg, device))
             if cfg.rope_local_theta else None)
    return glob, local


def _layer_rope(cfg: LLMConfig, li: int, tables):
    """Layer ``li``'s (cos, sin), or None on a NoPE layer: a zero angle's
    rotation is the identity, which skipping it gives bit for bit."""
    if _is_nope(cfg, li):
        return None
    if cfg.rope_local_theta and _is_sliding(cfg, li):
        return tables[1]
    return tables[0]


@functools.lru_cache(maxsize=None)
def _scalar(value: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor on ``device``, made once: a quotient by it is an
    IEEE division on the card too, where a Python divisor becomes a product
    with its f32 reciprocal."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _post_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  li: int, cfg: LLMConfig):
    """Llama-4's q/k after rope on (N, H, D) heads at (N,) positions: a
    weightless L2 (RMS) norm on rope layers, and on NoPE layers queries
    scaled by ``log1p(floor((pos + 1) / attn_temp_floor)) *
    attn_temp_scale + 1`` in f32 (the reference's order)."""
    nope = _is_nope(cfg, li)
    if cfg.qk_l2norm and not nope:
        q, k = _unit_rms(q, cfg.norm_eps), _unit_rms(k, cfg.norm_eps)
    if cfg.attn_temp_tuning and nope:
        pos = positions.float() + 1.0
        floor = _scalar(float(cfg.attn_temp_floor), pos.device)
        sc = torch.log1p(torch.floor(pos / floor)) * cfg.attn_temp_scale + 1.0
        q = (q.float() * sc[:, None, None]).to(q.dtype)
    return q, k


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Preallocated KV cache in the reference layout.

    ``k``/``v`` are (L, S_max, Hk, D) and are UPDATED IN PLACE by prefill,
    decode_step and extend: the returned cache shares their storage. That
    is safe under the runner's contract that rows at or past ``length`` are
    masked and never read: rolling back (lookahead chunks, EOS discard,
    prefix reuse) only lowers ``length``, and later writes overwrite those
    rows before any attention can see them. ``length`` is a host int, so
    positions and bucket choices never wait on the device."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, cfg: LLMConfig, dtype: torch.dtype = torch.bfloat16,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "KVCache":
        """Zeroed rows on ``device``, by default the CUDA card (with none
        it raises unless the CPU is asked for)."""
        device = default_device(device, "allocate a KV cache")
        s = max_seq or cfg.max_seq
        shape = (cfg.n_layers, s, cfg.n_kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


class VocabShard(NamedTuple):
    """A tensor-parallel rank's rows of the embedding: ``params["tok_emb"]``
    holds rows [start, start + its length) and ``comm`` (the mesh) sums the
    ranks' lookups."""

    start: int
    comm: Any


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (any shape). Under tensor
    parallelism (``params["vocab_shard"]``) each rank looks up the ids it
    holds, writes -0.0 for the others and the ranks' rows are summed in
    f32: x + (-0.0) is x for every x, so the sum is the row, bit for bit.
    Ids past the vocabulary are refused before any forward (the runner's
    and the server's tokenizer check)."""
    table = params["tok_emb"]
    shard = params.get("vocab_shard")
    if shard is None:
        return table[tokens.long()]
    ids = tokens.long() - shard.start
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)].float()
    rows = torch.where(mine[..., None], rows, rows.new_full((), -0.0))
    return shard.comm.all_reduce(rows).to(table.dtype)


def embed_token(params: Dict[str, Any], token) -> torch.Tensor:
    """One token's (1, D) row: an int, or a 0-d device tensor gathered on
    the device with no host sync."""
    if "vocab_shard" in params:
        if not isinstance(token, torch.Tensor):
            token = torch.tensor(int(token), device=params["tok_emb"].device)
        return embed_tokens(params, token.reshape(1))
    if isinstance(token, torch.Tensor):
        return params["tok_emb"].index_select(0, token.reshape(1).long())
    return params["tok_emb"][int(token)][None]


def _qkv(x: torch.Tensor, layer, cfg: LLMConfig, li: int, tables,
         positions: torch.Tensor):
    """Attention input, fused QKV projection (+ bias), head split, QK norms,
    layer ``li``'s rope (from ``tables``, none on a NoPE layer) and
    Llama-4's post-rope processing at ``positions`` (N,); returns (h, q
    (N, H, D), k (N, Hk, D), v (N, Hk, D))."""
    n = x.shape[0]
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    h = _attn_in(x, layer, cfg)
    qkv = _linear(h, layer["wqkv"])
    if cfg.qkv_bias:
        qkv = qkv + layer["wqkv_bias"]
    q = qkv[:, :qd].reshape(n, cfg.n_heads, cfg.head_dim)
    k = qkv[:, qd:qd + kvd].reshape(n, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[:, qd + kvd:].reshape(n, cfg.n_kv_heads, cfg.head_dim)
    q, k = _qk_norm(q, k, layer, cfg)
    rope = _layer_rope(cfg, li, tables)
    if rope is not None:
        q, k = _rotate(q, *rope), _rotate(k, *rope)
    if cfg.qk_l2norm or cfg.attn_temp_tuning:
        q, k = _post_rope_qk(q, k, positions, li, cfg)
    return h, q, k, v


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _bidir_prefill_attn(cfg: LLMConfig, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, bidir_len: int) -> torch.Tensor:
    """Prefix-LM prefill attention over q (S, H, D), k and v (S, Hk, D):
    positions before ``bidir_len`` attend to each other both ways, the rest
    causally (PaliGemma's inference mask, transformers
    ``modeling_paligemma._update_causal_mask``). Dense, as the reference's
    ``_bidir_prefill_attn``: the prompt pass runs once, and prefix-LM
    configs are plain attention. Returns (S, H * D) f32."""
    s, hk, hd = q.shape[0], cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // hk
    qg = q.reshape(s, hk, rep, hd).permute(1, 2, 0, 3).reshape(hk, -1, hd)
    scores = cache_scores(qg, k).reshape(hk, rep, s, s) * _attn_scale(cfg)
    if cfg.attn_softcap > 0.0:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    idx = torch.arange(s, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    bid = (idx[:, None] < bidir_len) & (idx[None, :] < bidir_len)
    scores = torch.where(causal | bid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    attn = cache_mix(probs.reshape(hk, rep * s, s), v)
    return attn.reshape(hk, rep, s, hd).permute(2, 0, 1, 3).reshape(s, -1)


def _input_rows(params: Dict[str, Any], tokens: torch.Tensor,
                embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The first hidden states: ``embeds`` (the multimodal injection point:
    image features spliced between text embeddings) in the embedding's
    dtype, else the token lookup."""
    if embeds is not None:
        return embeds.to(params["tok_emb"].dtype)
    return embed_tokens(params, tokens)


@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: LLMConfig, tokens: torch.Tensor,
            length: int, cache: KVCache,
            embeds: Optional[torch.Tensor] = None,
            bidir_len: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run a padded prompt bucket ``tokens`` (S_pad,) through the model and
    write its K/V into rows [0, S_pad) of the cache (in place). Returns the
    logits (V,) of the last real token and the cache at ``length``. Padded
    rows past ``length`` hold garbage that the length mask hides.

    ``embeds`` ((S_pad, dim)) replaces the token lookup: image features
    spliced over placeholder rows (models/clip.py, llm/vlm.py).
    ``bidir_len`` (<= ``length``) gives prefix-LM attention, dense
    (:func:`_bidir_prefill_attn`), on plain-attention configs only. With
    both None the pass is the causal one, with its kernels."""
    check_supported(cfg, params)
    if bidir_len is not None and (
            _layer_window(cfg) or cfg.attn_chunk or cfg.attn_sinks
            or cfg.nope_pattern > 1 or cfg.window_pattern > 1
            or cfg.alt_window):
        raise NotImplementedError(
            "prefix-LM (bidir_len) supports plain-attention configs only")
    s_pad = tokens.shape[0]
    positions = torch.arange(s_pad, device=tokens.device)
    tables = _rope_tables(params, cfg, positions, int(length))
    x = _input_rows(params, tokens, embeds)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h, q, k, v = _qkv(x, layer, cfg, li, tables, positions)
        cache.k[li, :s_pad] = k.to(cache.k.dtype)
        cache.v[li, :s_pad] = v.to(cache.v.dtype)
        if bidir_len is not None:
            attn = _bidir_prefill_attn(cfg, q, k, v, int(bidir_len))
        else:
            attn = prefill_attention(
                q.transpose(0, 1).contiguous(),
                k.transpose(0, 1).contiguous(),
                v.transpose(0, 1).contiguous(), causal=True,
                **_attn_kw(cfg, li, layer)).transpose(0, 1).reshape(s_pad, -1)
        x = _layer_tail(x, h, attn, layer, cfg, li)
    x_last = x[max(length - 1, 0)]
    logits = _output_logits(params, cfg, x_last[None])[0]
    return logits, KVCache(cache.k, cache.v, int(length))


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: LLMConfig, token,
                cache: KVCache, attn_len: Optional[int] = None,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One token (int or 0-d device tensor) at position ``cache.length``:
    writes its K/V row in place, returns logits (V,) and the cache at
    length + 1. ``attn_len`` bounds the cache prefix attention reads and
    must exceed ``cache.length``."""
    check_supported(cfg, params)
    pos = cache.length
    device = cache.k.device
    positions = torch.arange(pos, pos + 1, device=device)
    tables = _rope_tables(params, cfg, positions, pos + 1)
    x = embed_token(params, token)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h, q, k, v = _qkv(x, layer, cfg, li, tables, positions)
        cache.k[li, pos] = k[0].to(cache.k.dtype)
        cache.v[li, pos] = v[0].to(cache.v.dtype)
        k_view = cache.k[li, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :attn_len] if attn_len else cache.v[li]
        attn = decode_attention(q[0], k_view, v_view, pos + 1,
                                **_attn_kw(cfg, li, layer))
        x = _layer_tail(x, h, attn.reshape(1, -1), layer, cfg, li)
    logits = _output_logits(params, cfg, x)[0]
    return logits, KVCache(cache.k, cache.v, pos + 1)


@torch.no_grad()
def extend(params: Dict[str, Any], cfg: LLMConfig, tokens: torch.Tensor,
           n_valid: int, cache: KVCache, attn_len: Optional[int] = None,
           all_logits: bool = False, embeds: Optional[torch.Tensor] = None,
           ) -> Tuple[torch.Tensor, KVCache]:
    """Append a padded chunk ``tokens`` (B,) after ``cache.length`` in one
    parallel pass (chunked prefill): each chunk query attends to the cached
    prefix and causally within the chunk. K/V rows are written in place;
    padded rows that would fall past S_max are dropped (the valid ones must
    fit). Returns the logits at the last valid token, or with
    ``all_logits`` the (B, V) logits at every chunk position (the
    speculative verify pass), and the cache at length + n_valid.
    ``embeds`` ((B, dim)) replaces the token lookup, as in :func:`prefill`."""
    check_supported(cfg, params)
    offset = cache.length
    b = tokens.shape[0]
    s_max = cache.k.shape[1]
    if offset + n_valid > s_max:
        raise ValueError(f"extend past the cache: {offset} + {n_valid} > "
                         f"{s_max}")
    fit = min(b, s_max - offset)
    device = tokens.device
    positions = offset + torch.arange(b, device=device)
    tables = _rope_tables(params, cfg, positions, offset + int(n_valid))
    x = _input_rows(params, tokens, embeds)
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // hk
    # _attn_scale, not 1/sqrt(D): the reference's extend keeps the query
    # scalar and the longrope/YaRN factor, as decode_step does.
    scale = _attn_scale(cfg)
    key_idx = torch.arange(attn_len or s_max, device=device)[None, None, None]
    q_pos = positions[None, None, :, None]
    causal = key_idx <= q_pos
    masks = {}
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h, q, k, v = _qkv(x, layer, cfg, li, tables, positions)
        cache.k[li, offset:offset + fit] = k[:fit].to(cache.k.dtype)
        cache.v[li, offset:offset + fit] = v[:fit].to(cache.v.dtype)
        k_view = cache.k[li, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :attn_len] if attn_len else cache.v[li]
        # The reference keeps its window here under a chunk as well.
        window, chunk = _window_of(cfg, li), _chunk_of(cfg, li)
        if (window, chunk) not in masks:
            mask = causal
            if chunk:
                mask = mask & (key_idx >= (q_pos // chunk) * chunk)
            if window:
                mask = mask & (key_idx > q_pos - window)
            masks[window, chunk] = mask
        # (B, H, D) as (Hk, R * B, D): one batched product per KV head.
        qg = q.reshape(b, hk, rep, hd).permute(1, 2, 0, 3).reshape(hk, -1, hd)
        scores = cache_scores(qg, k_view).reshape(hk, rep, b, -1) * scale
        if cfg.attn_softcap > 0.0:
            scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
        scores = torch.where(masks[window, chunk], scores, NEG_INF)
        if cfg.attn_sinks:
            col = layer["attn_sink"].float().reshape(hk, rep, 1, 1).expand(
                hk, rep, b, 1)
            probs = torch.softmax(torch.cat([scores, col], dim=-1),
                                  dim=-1)[..., :-1]
        else:
            probs = torch.softmax(scores, dim=-1)
        attn = cache_mix(probs.reshape(hk, rep * b, -1), v_view)
        attn = attn.reshape(hk, rep, b, hd).permute(2, 0, 1, 3).reshape(b, -1)
        x = _layer_tail(x, h, attn, layer, cfg, li)
    final = KVCache(cache.k, cache.v, offset + int(n_valid))
    if all_logits:
        return _output_logits(params, cfg, x), final
    x_last = x[max(n_valid - 1, 0)]
    return _output_logits(params, cfg, x_last[None])[0], final


@torch.no_grad()
def generate_greedy(params: Dict[str, Any], cfg: LLMConfig, first_token,
                    cache: KVCache, n_tokens: int,
                    attn_len: Optional[int] = None,
                    ) -> Tuple[torch.Tensor, KVCache]:
    """``n_tokens`` greedy decode steps from ``first_token`` (an int or a
    0-d device tensor), the port of the JAX package's ``generate_greedy``:
    each step decodes the last token and takes the argmax of its logits.
    The tokens stay on the device, with no host sync inside the loop.
    Returns the (n_tokens,) int64 tokens after ``first_token`` and the cache
    at length + n_tokens; ``attn_len`` must cover that length."""
    toks = []
    tok = first_token
    for _ in range(n_tokens):
        logits, cache = decode_step(params, cfg, tok, cache,
                                    attn_len=attn_len)
        tok = torch.argmax(logits)
        toks.append(tok)
    return torch.stack(toks), cache


@torch.no_grad()
def decode_chunk_greedy(params: Dict[str, Any], cfg: LLMConfig,
                        logits: torch.Tensor, cache: KVCache, n_tokens: int,
                        attn_len: Optional[int] = None,
                        eos_id: Optional[int] = None,
                        suppress_until: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """``n_tokens`` greedy steps from a logits vector: the runner's k-token
    lookahead chunk. ``tokens[0] == argmax(logits)``, so the chain is the
    serial decode_step chain. The argmax tokens stay on the device (no
    host sync inside the chunk); the caller fetches the (n_tokens,) array
    once. With ``eos_id``, the first ``suppress_until`` steps ban EOS.
    Returns (tokens, logits after the last token, cache + n_tokens)."""
    toks = []
    lg = logits
    for step in range(n_tokens):
        if eos_id is not None and step < suppress_until:
            lg = lg.clone()
            lg[eos_id] = NEG_INF
        tok = torch.argmax(lg)
        toks.append(tok)
        lg, cache = decode_step(params, cfg, tok, cache, attn_len=attn_len)
    return torch.stack(toks), lg, cache


# ---------------------------------------------------------------------------
# Batched serving: many conversations, one weight stream
# ---------------------------------------------------------------------------

class BatchedKVCache(NamedTuple):
    """Per-slot KV caches for a fixed batch of conversations, the
    reference's continuous-batching layout.

    ``k``/``v`` are (L, B, S_max, Hk, D) and are updated in place, as
    :class:`KVCache`'s. ``lengths`` is a (B,) int32 tensor on the caches'
    device: rope positions, cache-row writes and attention masks read it
    there, so a step never waits on the host; the server keeps the host's
    copy of each slot's length."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int,
               dtype: torch.dtype = torch.bfloat16,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "BatchedKVCache":
        """Zeroed slots on ``device``, by default the CUDA card (with none
        it raises unless the CPU is asked for)."""
        device = default_device(device, "allocate a KV cache")
        s = max_seq or cfg.max_seq
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


@torch.no_grad()
def prefill_batch(params: Dict[str, Any], cfg: LLMConfig,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  cache_dtype: torch.dtype = torch.bfloat16,
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Bucketed prefill of an admission wave: ``tokens`` (B, S_pad),
    ``lengths`` (B,) on the same device. Returns the (B, V) logits of each
    row's last real token and a :class:`KVCache` whose k/v are (B, L,
    S_max, Hk, D) and whose ``length`` is ``lengths``.

    The matmuls run on the wave flattened to (B * S_pad, D), so each
    weight is read once for every prompt admitted together. Rows never
    attend across sequences: attention folds the batch into the heads,
    (B * H, S_pad, D) queries against (B * Hk, S_pad, D) keys, which is
    the per-row attention with each row's heads in their own group. Rows
    past a request's length hold garbage, as single prefill's padded
    tail; dummy rows (length 0) are legal. Longrope picks its set by the
    wave's longest row, on the device."""
    check_supported(cfg, params)
    b, s_pad = tokens.shape
    device = tokens.device
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.arange(s_pad, device=device).repeat(b)
    tables = _rope_tables(params, cfg, positions, lengths.max())
    x = embed_tokens(params, tokens.reshape(-1))            # (B * S, D)
    shape = (b, cfg.n_layers, cfg.max_seq, hk, hd)
    k_full = torch.zeros(shape, dtype=cache_dtype, device=device)
    v_full = torch.zeros(shape, dtype=cache_dtype, device=device)

    def heads(t, n):  # (B * S, n, D) -> (B * n, S, D)
        return t.reshape(b, s_pad, n, hd).transpose(1, 2).reshape(
            b * n, s_pad, hd)

    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h, q, k, v = _qkv(x, layer, cfg, li, tables, positions)
        k_full[:, li, :s_pad] = k.reshape(b, s_pad, hk, hd).to(cache_dtype)
        v_full[:, li, :s_pad] = v.reshape(b, s_pad, hk, hd).to(cache_dtype)
        kw = _attn_kw(cfg, li, layer)
        if kw["sinks"] is not None:  # folded heads: row i's head h is i*H+h
            kw["sinks"] = kw["sinks"].repeat(b)
        attn = prefill_attention(heads(q, hq), heads(k, hk), heads(v, hk),
                                 causal=True, **kw)
        attn = attn.reshape(b, hq, s_pad, hd).transpose(1, 2).reshape(
            b * s_pad, hq * hd)
        x = _layer_tail(x, h, attn, layer, cfg, li)
    last = (lengths.long() - 1).clamp_min(0)
    x_last = x.reshape(b, s_pad, -1)[torch.arange(b, device=device), last]
    logits = _output_logits(params, cfg, x_last)
    return logits, KVCache(k_full, v_full, lengths)


@torch.no_grad()
def insert_sequence(cache: BatchedKVCache, cfg: LLMConfig, slot: int,
                    seq_cache: KVCache) -> BatchedKVCache:
    """Copy a single-sequence cache (from prefill) into batch slot
    ``slot`` in place; the slot's length follows the sequence's."""
    s = seq_cache.k.shape[1]
    cache.k[:, slot, :s] = seq_cache.k.to(cache.k.dtype)
    cache.v[:, slot, :s] = seq_cache.v.to(cache.v.dtype)
    cache.lengths[slot] = int(seq_cache.length)
    return cache


def _write_rows(cache_l: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                val: torch.Tensor, active: torch.Tensor) -> None:
    """Write ``val`` (B, ...) at each slot's row ``pos`` of ``cache_l``
    (B, S, ...) in place; an inactive slot keeps what it held."""
    old = cache_l[rows, pos]
    keep = active.reshape(-1, *([1] * (val.dim() - 1)))
    cache_l[rows, pos] = torch.where(keep, val.to(cache_l.dtype), old)


@torch.no_grad()
def decode_step_batch(params: Dict[str, Any], cfg: LLMConfig,
                      tokens: torch.Tensor, active: torch.Tensor,
                      cache: BatchedKVCache,
                      attn_len: Optional[int] = None,
                      ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """One decode step for every slot: ``tokens`` (B,) -> logits (B, V).
    Inactive slots (``active`` False) compute but write nothing and do not
    advance. Positions, writes and masks come from ``cache.lengths`` on the
    device, for all slots at once. ``attn_len`` bounds every slot's KV
    reads and must exceed the longest active length."""
    check_supported(cfg, params)
    b = tokens.shape[0]
    device = tokens.device
    pos = cache.lengths.long()
    rows = torch.arange(b, device=device)
    # A dynamic_update_slice start is clamped to the last row.
    wpos = pos.clamp_max(cache.k.shape[2] - 1)
    tables = _rope_tables(params, cfg, pos, pos.max() + 1)
    x = embed_tokens(params, tokens)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        h, q, k, v = _qkv(x, layer, cfg, li, tables, pos)
        _write_rows(cache.k[li], rows, wpos, k, active)
        _write_rows(cache.v[li], rows, wpos, v, active)
        k_view = cache.k[li, :, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :, :attn_len] if attn_len else cache.v[li]
        attn = decode_attention_batch(q, k_view, v_view, pos + 1,
                                      **_attn_kw(cfg, li, layer))
        x = _layer_tail(x, h, attn.reshape(b, -1), layer, cfg, li)
    logits = _output_logits(params, cfg, x)
    lengths = torch.where(active, cache.lengths + 1, cache.lengths)
    return logits, BatchedKVCache(cache.k, cache.v, lengths)


@torch.no_grad()
def decode_steps_batch(params: Dict[str, Any], cfg: LLMConfig,
                       tokens: torch.Tensor, active: torch.Tensor,
                       cache: BatchedKVCache, n_steps: int,
                       attn_len: Optional[int] = None,
                       ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """``n_steps`` greedy :func:`decode_step_batch` steps with each step's
    argmax fed back on the device: no host fetch inside the chunk. Returns
    ``(produced (n_steps, B), cache)``, ``produced[j]`` the tokens chosen
    after step ``j`` (the chain t1..t_k from t0 = ``tokens``). Inactive
    slots compute but never advance."""
    produced = []
    toks = tokens
    for _ in range(n_steps):
        logits, cache = decode_step_batch(params, cfg, toks, active, cache,
                                          attn_len=attn_len)
        toks = torch.argmax(logits, dim=-1)
        produced.append(toks)
    return torch.stack(produced), cache
