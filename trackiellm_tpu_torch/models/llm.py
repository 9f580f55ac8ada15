"""Mistral-7B-class decoder-only transformer, in PyTorch.

Port of the Mistral slice of ``trackiellm_tpu/models/llm.py``: RMSNorm,
split-half rotary embeddings, grouped-query attention with an optional
sliding window, SwiGLU MLP, Q4/Q8 group-quantized or dense weights, and a
KV cache in the reference's (L, S_max, Hk, D) layout, and the batched
serving functions (``prefill_batch``, ``BatchedKVCache``,
``insert_sequence``, ``decode_step_batch``, ``decode_steps_batch``) that
``llm/server.py`` and ``llm/paging.py`` drive.

Parameters keep the JAX pytree layout (stacked ``(L, ...)`` layer tensors,
fused ``wqkv`` and ``w_gu``), so ``models/bridge.py`` maps the JAX
package's params onto these byte for byte. The reference's ``lax.scan``
over layers is a Python loop over per-layer views of the stacked tensors.
Configs that set knobs of other model families raise NotImplementedError.
"""

from __future__ import annotations

import functools
import math
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
from trackiellm_tpu_torch.ops.backend import default_device, is_cuda
from trackiellm_tpu_torch.ops.quant import (
    QuantizedLinear,
    quantize_q4,
    quantize_q8,
    quantized_matmul,
)


class LLMConfig(NamedTuple):
    """Field names and defaults of ``trackiellm_tpu.models.llm.LLMConfig``,
    so ``LLMConfig(**jax_cfg._asdict())`` works. Only the Mistral knob set
    is supported (see :func:`check_supported`)."""

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
    def tiny(cls) -> "LLMConfig":
        """Small config for tests."""
        return cls(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                   n_kv_heads=2, head_dim=64, hidden_dim=512, max_seq=256,
                   sliding_window=256)


# Knobs of other model families and the only value this slice runs. Knobs
# read only under one of these (MoE routing details, temperature-tuning
# constants, act_limit) are inert at these values, as in the reference.
_MISTRAL_KNOBS = {
    "qkv_bias": False, "act": "silu", "post_norms": False,
    "pre_norms": True, "attn_softcap": 0.0, "logit_softcap": 0.0,
    "query_pre_attn_scalar": 0.0, "residual_multiplier": 1.0,
    "partial_rotary_factor": 1.0, "qk_l2norm": False,
    "attn_temp_tuning": False, "attn_chunk": 0, "moe_pattern": 0,
    "moe_first_dense": 0, "norm_type": "rms", "parallel_residual": False,
    "parallel_mlp_norm": False, "mlp_gated": True, "mlp_bias": False,
    "alt_window": False, "window_pattern": 0, "rope_local_theta": 0.0,
    "nope_pattern": 0, "rope_original_max_seq": 0,
    "rope_attention_factor": 1.0, "n_experts": 0, "qk_norm": False,
    "qk_norm_full": False, "attn_sinks": False, "out_bias": False,
    "moe_bias": False,
}


def check_supported(cfg: LLMConfig,
                    params: Optional[Dict[str, Any]] = None) -> None:
    """Raise NotImplementedError naming the first knob outside the Mistral
    set (ROADMAP Queue 1 item 11 ports the other families)."""
    for name, value in _MISTRAL_KNOBS.items():
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"LLMConfig.{name}={getattr(cfg, name)!r}: only the Mistral "
                f"knob set is ported ({name}={value!r}); other families wait "
                "for ROADMAP Queue 1 item 11")
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    if params is not None:
        for name in ("rope_factors", "rope_factors_short", "rope_factors_long"):
            if name in params:
                raise NotImplementedError(
                    f"params[{name!r}] (rope scaling) is not ported yet "
                    "(ROADMAP Queue 1 item 11)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _shapes(cfg: LLMConfig) -> Dict[str, Tuple[int, int]]:
    d, h = cfg.dim, cfg.hidden_dim
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    return {"wqkv": (d, qd + 2 * kvd), "wo": (qd, d),
            "w_gu": (d, 2 * h), "w_down": (h, d)}


def init_params(generator: torch.Generator, cfg: LLMConfig,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random dense params in the reference's layout (stacked layers).
    ``generator`` must live on ``device``."""
    check_supported(cfg)
    d, l = cfg.dim, cfg.n_layers

    def w(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2])
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    layers = {"attn_norm": torch.ones((l, d), dtype=dtype, device=device),
              "mlp_norm": torch.ones((l, d), dtype=dtype, device=device)}
    for name, (kk, nn) in _shapes(cfg).items():
        layers[name] = w(l, kk, nn)
    return {
        "tok_emb": w(cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": w(d, cfg.vocab_size),
    }


def _stack_quantized(mats, quantize, group: int) -> QuantizedLinear:
    qs = [quantize(m, group) for m in mats]
    return QuantizedLinear(values=torch.stack([q.values for q in qs]),
                           scales=torch.stack([q.scales for q in qs]))


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    group: int = 256) -> Dict[str, Any]:
    """Quantize the per-layer matrices and lm_head (Q4 or Q8); embeddings
    and norms keep their dtype."""
    quantize = quantize_q4 if bits == 4 else quantize_q8
    out = dict(params)
    layers = dict(params["layers"])
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        layers[name] = _stack_quantized(layers[name], quantize, group)
    out["layers"] = layers
    out["lm_head"] = quantize(params["lm_head"], group)
    return out


def init_params_quantized(generator: torch.Generator, cfg: LLMConfig,
                          bits: int = 4, group: int = 256,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Random params straight into quantized form, one (K, N) matrix at a
    time, so peak memory is one f32 matrix beside the quantized model.
    ``generator`` must live on ``device``."""
    check_supported(cfg)
    quantize = quantize_q4 if bits == 4 else quantize_q8
    d, l = cfg.dim, cfg.n_layers

    def build_one(kk, nn):
        w = torch.randn((kk, nn), generator=generator, device=device)
        return quantize(w / math.sqrt(kk), group)

    layers: Dict[str, Any] = {
        "attn_norm": torch.ones((l, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((l, d), dtype=dtype, device=device),
    }
    for name, (kk, nn) in _shapes(cfg).items():
        first = build_one(kk, nn)
        values = torch.empty((l, *first.values.shape),
                             dtype=first.values.dtype, device=device)
        scales = torch.empty((l, *first.scales.shape), dtype=torch.float32,
                             device=device)
        values[0], scales[0] = first.values, first.scales
        for i in range(1, l):
            q = build_one(kk, nn)
            values[i], scales[i] = q.values, q.scales
        layers[name] = QuantizedLinear(values=values, scales=scales)
    tok_emb = (torch.randn((cfg.vocab_size, d), generator=generator,
                           device=device) * 0.02).to(dtype)
    return {
        "tok_emb": tok_emb,
        "layers": layers,
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": build_one(d, cfg.vocab_size),
    }


def params_to(params: Any, device: torch.device) -> Any:
    """A copy of a param tree on ``device`` (None leaves stay None)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, QuantizedLinear):
        return QuantizedLinear(params.values.to(device),
                               params.scales.to(device))
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return None if params is None else params.to(device)


def _layer(layers: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li``'s view of the stacked layer params (no copies)."""
    out = {}
    for name, w in layers.items():
        if isinstance(w, QuantizedLinear):
            out[name] = QuantizedLinear(w.values[li], w.scales[li])
        else:
            out[name] = w[li]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, w) -> torch.Tensor:
    """Projection through a QuantizedLinear or a dense (K, N) weight, f32
    sums cast back to x's dtype. A dense bf16 weight on the card is read as
    it is stored, with f32 sums (``torch.mm(..., out_dtype=float32)``, the
    reference's ``preferred_element_type=f32``): an f32 copy of the weight
    would cost its traffic on every call. The CPU widens both to f32."""
    if isinstance(w, QuantizedLinear):
        return quantized_matmul(x, w).to(x.dtype)
    if is_cuda(x) and x.dtype == w.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMS norm, cast to x's dtype, then scaled. On the card it is
    PyTorch's fused RMS norm, which reduces each row in a block of its own:
    a row gets the same bits whether the call holds one row (a decode step)
    or sixteen (a verify pass), so greedy speculation keeps plain decode's
    ids. The unfused f32 mean's order depends on the row count there, and
    one flipped rounding of a norm can change a greedy token."""
    if is_cuda(x):
        return F.rms_norm(x, (x.shape[-1],), eps=eps) * scale
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * scale


def _act_combine(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU (f32 in and out)."""
    return F.silu(gate) * up


def _mlp_block(x: torch.Tensor, norm_scale: torch.Tensor, w_gu, w_down,
               eps: float) -> torch.Tensor:
    """norm -> gate/up -> silu(gate) * up -> down -> + residual.

    Small-M Q4 weights take the one-launch fused block (``ops/fused.py``)
    behind the ``TRACKIE_FUSED_MLP=1`` opt-in, read at each call, under the
    Mistral subset of the JAX package's condition (``llm.py:764-769``):
    decode and the lookahead chunk take it, prefill and extend (M > 8) and
    Q8 weights do not."""
    if (x.dim() == 2 and fused.use_fused_mlp()
            and fused._can_fuse(x, w_gu, w_down)):
        return fused.fused_mlp(x, norm_scale, w_gu, w_down, eps)
    h2 = _rms_norm(x, norm_scale, eps)
    gu = _linear(h2, w_gu).float()
    gate, up = gu.chunk(2, dim=-1)
    return x + _linear(_act_combine(gate, up).to(x.dtype), w_down)


def _attn_residual(x: torch.Tensor, attn_out: torch.Tensor,
                   layer: Dict[str, Any]) -> torch.Tensor:
    """wo projection + residual."""
    return x + _linear(attn_out.to(x.dtype), layer["wo"])


def _layer_tail(x, attn, layer, cfg: LLMConfig) -> torch.Tensor:
    x = _attn_residual(x, attn, layer)
    return _mlp_block(x, layer["mlp_norm"], layer["w_gu"], layer["w_down"],
                      cfg.norm_eps)


def _output_logits(params: Dict[str, Any], cfg: LLMConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """Final norm -> lm_head, f32."""
    h = _rms_norm(x, params["out_norm"], cfg.norm_eps)
    return _linear(h, params["lm_head"]).float()


def _layer_window(cfg: LLMConfig) -> int:
    return cfg.sliding_window if 0 < cfg.sliding_window < cfg.max_seq else 0


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(cfg: LLMConfig, device=None) -> torch.Tensor:
    """The (head_dim / 2,) f32 rope frequencies, made once per (head_dim,
    theta, device): building them copies theta to the device, which on
    the card waits for the stream."""
    return _rope_freqs_on(cfg.head_dim, cfg.rope_theta,
                          None if device is None else torch.device(device))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, device=device), exps)


def yarn_rope_factors(cfg: LLMConfig, factor: float, original_max_seq: int,
                      beta_fast: float = 32.0, beta_slow: float = 1.0,
                      truncate: bool = True) -> torch.Tensor:
    """YaRN per-frequency rope divisors, f32 (head_dim / 2,) on the CPU
    (``trackiellm_tpu/models/llm.py:yarn_rope_factors``): dims with more
    than ``beta_fast`` rotations over the original context extrapolate
    (divisor 1), dims with fewer than ``beta_slow`` interpolate (divisor
    ``factor``), the band between blends linearly by dim index. Only the
    GGUF converter calls it, for yarn-scaled files; running such params
    waits for rope scaling (``check_supported``)."""
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
    ang = positions[..., :, None].float() * freqs              # (S, D/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """Rotate (..., S, H, D) by per-position angles, split-half layout."""
    return _rotate(x, *_rope_cos_sin(positions, freqs))


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


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_emb"][tokens.long()]


def _qkv(x: torch.Tensor, layer, cfg: LLMConfig, cos, sin):
    """Pre-norm, fused QKV projection, head split and rope; returns
    (h, q (S, H, D), k (S, Hk, D), v (S, Hk, D))."""
    s = x.shape[0]
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    qkv = _linear(h, layer["wqkv"])
    q = qkv[:, :qd].reshape(s, cfg.n_heads, cfg.head_dim)
    k = qkv[:, qd:qd + kvd].reshape(s, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[:, qd + kvd:].reshape(s, cfg.n_kv_heads, cfg.head_dim)
    return h, _rotate(q, cos, sin), _rotate(k, cos, sin), v


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: LLMConfig, tokens: torch.Tensor,
            length: int, cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Run a padded prompt bucket ``tokens`` (S_pad,) through the model and
    write its K/V into rows [0, S_pad) of the cache (in place). Returns the
    logits (V,) of the last real token and the cache at ``length``. Padded
    rows past ``length`` hold garbage that the length mask hides."""
    check_supported(cfg, params)
    s_pad = tokens.shape[0]
    device = tokens.device
    positions = torch.arange(s_pad, device=device)
    cos, sin = _rope_cos_sin(positions, _rope_freqs(cfg, device))
    x = params["tok_emb"][tokens.long()]
    window = _layer_window(cfg)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        _, q, k, v = _qkv(x, layer, cfg, cos, sin)
        cache.k[li, :s_pad] = k.to(cache.k.dtype)
        cache.v[li, :s_pad] = v.to(cache.v.dtype)
        attn = prefill_attention(
            q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
            v.transpose(0, 1).contiguous(), causal=True, window=window)
        x = _layer_tail(x, attn.transpose(0, 1).reshape(s_pad, -1), layer,
                        cfg)
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
    cos, sin = _rope_cos_sin(positions, _rope_freqs(cfg, device))
    if isinstance(token, torch.Tensor):  # device token: gather, no sync
        x = params["tok_emb"].index_select(0, token.reshape(1).long())
    else:
        x = params["tok_emb"][int(token)][None]
    window = _layer_window(cfg)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        _, q, k, v = _qkv(x, layer, cfg, cos, sin)
        cache.k[li, pos] = k[0].to(cache.k.dtype)
        cache.v[li, pos] = v[0].to(cache.v.dtype)
        k_view = cache.k[li, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :attn_len] if attn_len else cache.v[li]
        attn = decode_attention(q[0], k_view, v_view, pos + 1, window=window)
        x = _layer_tail(x, attn.reshape(1, -1), layer, cfg)
    logits = _output_logits(params, cfg, x)[0]
    return logits, KVCache(cache.k, cache.v, pos + 1)


@torch.no_grad()
def extend(params: Dict[str, Any], cfg: LLMConfig, tokens: torch.Tensor,
           n_valid: int, cache: KVCache, attn_len: Optional[int] = None,
           all_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Append a padded chunk ``tokens`` (B,) after ``cache.length`` in one
    parallel pass (chunked prefill): each chunk query attends to the cached
    prefix and causally within the chunk. K/V rows are written in place;
    padded rows that would fall past S_max are dropped (the valid ones must
    fit). Returns the logits at the last valid token, or with
    ``all_logits`` the (B, V) logits at every chunk position (the
    speculative verify pass), and the cache at length + n_valid."""
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
    cos, sin = _rope_cos_sin(positions, _rope_freqs(cfg, device))
    x = params["tok_emb"][tokens.long()]
    window = _layer_window(cfg)
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // hk
    scale = 1.0 / math.sqrt(hd)
    key_idx = torch.arange(attn_len or s_max, device=device)[None, None, None]
    q_pos = positions[None, None, :, None]
    mask = key_idx <= q_pos
    if window:
        mask &= key_idx > q_pos - window
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        _, q, k, v = _qkv(x, layer, cfg, cos, sin)
        cache.k[li, offset:offset + fit] = k[:fit].to(cache.k.dtype)
        cache.v[li, offset:offset + fit] = v[:fit].to(cache.v.dtype)
        k_view = cache.k[li, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :attn_len] if attn_len else cache.v[li]
        # (B, H, D) as (Hk, R * B, D): one batched product per KV head.
        qg = q.reshape(b, hk, rep, hd).permute(1, 2, 0, 3).reshape(hk, -1, hd)
        scores = cache_scores(qg, k_view).reshape(hk, rep, b, -1) * scale
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).reshape(hk, rep * b, -1)
        attn = cache_mix(probs, v_view).reshape(hk, rep, b, hd)
        attn = attn.permute(2, 0, 1, 3).reshape(b, -1)
        x = _layer_tail(x, attn, layer, cfg)
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
    tail; dummy rows (length 0) are legal."""
    check_supported(cfg, params)
    b, s_pad = tokens.shape
    device = tokens.device
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.arange(s_pad, device=device).repeat(b)
    cos, sin = _rope_cos_sin(positions, _rope_freqs(cfg, device))
    x = params["tok_emb"][tokens.reshape(-1).long()]        # (B * S, D)
    window = _layer_window(cfg)
    shape = (b, cfg.n_layers, cfg.max_seq, hk, hd)
    k_full = torch.zeros(shape, dtype=cache_dtype, device=device)
    v_full = torch.zeros(shape, dtype=cache_dtype, device=device)

    def heads(t, n):  # (B * S, n, D) -> (B * n, S, D)
        return t.reshape(b, s_pad, n, hd).transpose(1, 2).reshape(
            b * n, s_pad, hd)

    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        _, q, k, v = _qkv(x, layer, cfg, cos, sin)
        k_full[:, li, :s_pad] = k.reshape(b, s_pad, hk, hd).to(cache_dtype)
        v_full[:, li, :s_pad] = v.reshape(b, s_pad, hk, hd).to(cache_dtype)
        attn = prefill_attention(heads(q, hq), heads(k, hk), heads(v, hk),
                                 causal=True, window=window)
        attn = attn.reshape(b, hq, s_pad, hd).transpose(1, 2).reshape(
            b * s_pad, hq * hd)
        x = _layer_tail(x, attn, layer, cfg)
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
    """Write ``val`` (B, Hk, D) at each slot's row ``pos`` of ``cache_l``
    (B, S, Hk, D) in place; an inactive slot keeps what it held."""
    old = cache_l[rows, pos]
    cache_l[rows, pos] = torch.where(active[:, None, None],
                                     val.to(cache_l.dtype), old)


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
    cos, sin = _rope_cos_sin(pos, _rope_freqs(cfg, device))
    x = params["tok_emb"].index_select(0, tokens.long())
    window = _layer_window(cfg)
    for li in range(cfg.n_layers):
        layer = _layer(params["layers"], li)
        _, q, k, v = _qkv(x, layer, cfg, cos, sin)
        _write_rows(cache.k[li], rows, wpos, k, active)
        _write_rows(cache.v[li], rows, wpos, v, active)
        k_view = cache.k[li, :, :attn_len] if attn_len else cache.k[li]
        v_view = cache.v[li, :, :attn_len] if attn_len else cache.v[li]
        attn = decode_attention_batch(q, k_view, v_view, pos + 1,
                                      window=window)
        x = _layer_tail(x, attn.reshape(b, -1), layer, cfg)
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
