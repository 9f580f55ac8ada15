"""DeepSeek-V2/V3 family: Multi-head Latent Attention (MLA).

Port of ``trackiellm_tpu/models/mla.py``: the same configs, params tree
(``attn`` stacks every layer; ``dense_mlp`` the first ``first_k_dense``,
``moe_mlp`` the rest), cache and forward surface. The MoE side (softmax or
sigmoid scores with the selection bias, group-limited top-k by max or
top-2 sum, routed scaling, ungated shared experts) is ``models/llm.py``'s
``_moe_block``, which reads this config's ``moe_*`` fields as it reads
LLMConfig's.

The cache holds the compressed latent: per token and layer the normed
``kv_lora_rank`` latent and the rotated shared rope key (576 values for
V2, against 8,192 of decompressed K/V at V2-Lite's 16 heads).

- Prefill decompresses K and V (V zero-padded to ``qk_head_dim``, 192) and
  runs ``ops/attention.py:prefill_attention``: on the card at S >= 256 the
  flash kernel of ``csrc/flash_attn.cu`` at head dim 192; it writes only
  the latent.
- Decode and extend run the absorbed form: q_nope through the per-head
  K-up bank, scores against the shared latent as in MQA, the V-up bank
  after the softmax. The reference widens the latent cache and the banks
  to f32 every layer and token; on the card the port reads them as stored
  (bf16) in products with f32 sums, splitting each f32 operand into two
  bf16 terms (hi + lo, 16 of its 24 mantissa bits): every product is exact
  in f32, and the sums differ from the reference's only in their order and
  in the lo term's last bits.

Q4 and Q8 projections (``wq``/``wq_b``, ``wo``, the MLPs, the experts and
``lm_head``) take the quantized kernels through ``_linear``; ``wkv_a`` and
``wkv_b`` stay in their float dtype, as the reference keeps them.
"""

from __future__ import annotations

import math
import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.models.llm import (_layer, _linear, _mlp_block,
                                             _moe_block, _quantize_stack,
                                             _rms_norm, _rope_freqs_on,
                                             _write_rows, embed_token,
                                             embed_tokens, quantized_stack)
from trackiellm_tpu_torch.ops.attention import prefill_attention
from trackiellm_tpu_torch.ops.backend import default_device, is_cuda
from trackiellm_tpu_torch.ops.quant import quantize_q4, quantize_q8


class MLAConfig(NamedTuple):
    """DeepSeek-V2 geometry. The moe_*/act/norm fields carry LLMConfig's
    names, so ``models/llm.py``'s MoE block reads this config unchanged."""
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    hidden_dim: int              # dense-layer MLP width
    q_lora_rank: int = 0         # 0 = full q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_experts: int = 0
    n_experts_used: int = 6
    moe_hidden_dim: int = 0      # routed expert width
    moe_norm_topk: bool = False
    moe_shared_hidden: int = 0   # n_shared_experts * moe_hidden_dim
    moe_shared_gated: bool = False
    moe_routed_scale: float = 1.0
    moe_n_groups: int = 1
    moe_topk_groups: int = 1
    moe_score_func: str = "softmax"   # V3: "sigmoid"
    moe_group_score: str = "max"      # V3: "top2sum"
    # Read by the shared MoE/MLP helpers (other families' knobs).
    moe_bias: bool = False
    act_limit: float = 7.0
    moe_scale_input: bool = False
    moe_pattern: int = 0
    moe_first_dense: int = 0
    residual_multiplier: float = 1.0
    norm_type: str = "rms"
    parallel_residual: bool = False
    mlp_gated: bool = True
    mlp_bias: bool = False
    first_k_dense: int = 1
    act: str = "silu"
    post_norms: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq: int = 4096
    attn_scale_mult: float = 1.0  # the yarn mscale^2 hook

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def attn_scale(self) -> float:
        return self.attn_scale_mult / math.sqrt(self.qk_head_dim)

    @classmethod
    def deepseek_v2_lite(cls) -> "MLAConfig":
        """DeepSeek-V2-Lite 16B-A2.4B: full q_proj, 27 layers with layer 0
        dense, 64 routed + 2 shared experts."""
        return cls(vocab_size=102400, dim=2048, n_layers=27, n_heads=16,
                   hidden_dim=10944, q_lora_rank=0, kv_lora_rank=512,
                   n_experts=64, n_experts_used=6, moe_hidden_dim=1408,
                   moe_shared_hidden=2816, first_k_dense=1,
                   rope_theta=10000.0, max_seq=8192)

    @classmethod
    def deepseek_v2(cls) -> "MLAConfig":
        """DeepSeek-V2 236B-A21B: q LoRA rank 1536, 160 routed experts in 8
        groups (top-3 groups, top-6 experts), 2 shared, routed scale 16."""
        return cls(vocab_size=102400, dim=5120, n_layers=60, n_heads=128,
                   hidden_dim=12288, q_lora_rank=1536, kv_lora_rank=512,
                   n_experts=160, n_experts_used=6, moe_hidden_dim=1536,
                   moe_shared_hidden=3072, moe_routed_scale=16.0,
                   moe_n_groups=8, moe_topk_groups=3, first_k_dense=1,
                   rope_theta=10000.0, max_seq=8192)

    @classmethod
    def deepseek_v3(cls) -> "MLAConfig":
        """DeepSeek-V3/R1 671B-A37B: sigmoid routing with the selection
        bias (``moe_mlp.moe_gate_bias``), top-2-sum group scores over 8
        groups (top 4), 256 routed + 1 shared expert, renormalized top 8,
        routed scale 2.5, 3 dense layers."""
        return cls(vocab_size=129280, dim=7168, n_layers=61,
                   n_heads=128, hidden_dim=18432, q_lora_rank=1536,
                   kv_lora_rank=512, n_experts=256, n_experts_used=8,
                   moe_hidden_dim=2048, moe_shared_hidden=2048,
                   moe_norm_topk=True, moe_routed_scale=2.5,
                   moe_n_groups=8, moe_topk_groups=4,
                   moe_score_func="sigmoid", moe_group_score="top2sum",
                   first_k_dense=3, rope_theta=10000.0, max_seq=8192)

    @classmethod
    def tiny(cls) -> "MLAConfig":
        return cls(vocab_size=256, dim=32, n_layers=3, n_heads=2,
                   hidden_dim=64, q_lora_rank=0, kv_lora_rank=16,
                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=12, n_experts=4, n_experts_used=2,
                   moe_hidden_dim=24, moe_shared_hidden=48,
                   first_k_dense=1, max_seq=128)


def _k_dense(cfg: MLAConfig) -> int:
    return cfg.first_k_dense if cfg.n_experts else cfg.n_layers


def _matrices(cfg: MLAConfig) -> Dict[str, Dict[str, tuple]]:
    """Every stacked matrix by part: name -> (leading dims, K, N)."""
    l, d, h = cfg.n_layers, cfg.dim, cfg.n_heads
    r, rope, nope, vd = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                         cfg.qk_nope_head_dim, cfg.v_head_dim)
    attn = {"wkv_a": ((l,), d, r + rope), "wkv_b": ((l,), r, h * (nope + vd)),
            "wo": ((l,), h * vd, d)}
    if cfg.q_lora_rank:
        attn["wq_a"] = ((l,), d, cfg.q_lora_rank)
        attn["wq_b"] = ((l,), cfg.q_lora_rank, h * cfg.qk_head_dim)
    else:
        attn["wq"] = ((l,), d, h * cfg.qk_head_dim)
    k = _k_dense(cfg)
    dense = ({"w_gu": ((k,), d, 2 * cfg.hidden_dim),
              "w_down": ((k,), cfg.hidden_dim, d)} if k else {})
    m = l - k
    moe: Dict[str, tuple] = {}
    if m:
        e = cfg.n_experts
        moe = {"moe_gate": ((m,), d, e),
               "w_gu": ((m, e), d, 2 * cfg.moe_hidden_dim),
               "w_down": ((m, e), cfg.moe_hidden_dim, d)}
        if cfg.moe_shared_hidden:
            moe["shared_gu"] = ((m,), d, 2 * cfg.moe_shared_hidden)
            moe["shared_down"] = ((m,), cfg.moe_shared_hidden, d)
    return {"attn": attn, "dense_mlp": dense, "moe_mlp": moe}


# Matrices quantize_params quantizes (wkv_a, wkv_b and the router stay).
_QUANTIZABLE = ("wq", "wq_b", "wo", "w_gu", "w_down", "shared_gu",
                "shared_down")


def _norms(cfg: MLAConfig, dtype, device) -> Dict[str, torch.Tensor]:
    l = cfg.n_layers
    out = {"attn_norm": torch.ones((l, cfg.dim), dtype=dtype, device=device),
           "mlp_norm": torch.ones((l, cfg.dim), dtype=dtype, device=device),
           "kv_a_norm": torch.ones((l, cfg.kv_lora_rank), dtype=dtype,
                                   device=device)}
    if cfg.q_lora_rank:
        out["q_a_norm"] = torch.ones((l, cfg.q_lora_rank), dtype=dtype,
                                     device=device)
    return out


def _tree(cfg: MLAConfig, build, dtype, device) -> Dict[str, Any]:
    parts = {part: {name: build(name, *spec) for name, spec in mats.items()}
             for part, mats in _matrices(cfg).items()}
    parts["attn"].update(_norms(cfg, dtype, device))
    return parts


def group_for(k: int, group: int, bits: int) -> int:
    """The quantization group of a (K, N) matrix: ``group``, halved until it
    divides K (Q8) or K/2 (Q4). DeepSeek-V2-Lite's dense ``w_down`` (K =
    10,944, K/2 = 2^5 * 171) takes 32 at Q4 where every other matrix takes
    the default 64; the reference's ``quantize_params`` asserts there, and
    gives the same bytes wherever it does not."""
    span = k // 2 if bits == 4 else k
    while group > 1 and span % group:
        group //= 2
    return group


def init_params(generator: torch.Generator, cfg: MLAConfig,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random params in the stacked layout (matrices at 1/sqrt(fan-in), the
    embedding at 0.02, norms at one); ``generator`` lives on ``device``."""
    device = default_device(device, "build MLA params")

    def w(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2])
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    parts = _tree(cfg, lambda name, lead, kk, nn: w(*lead, kk, nn), dtype,
                  device)
    return {"tok_emb": w(cfg.vocab_size, cfg.dim, scale=0.02), **parts,
            "out_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
            "lm_head": w(cfg.dim, cfg.vocab_size)}


def init_params_quantized(generator: torch.Generator, cfg: MLAConfig,
                          bits: int = 4, group: int = 64,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Random params straight into :func:`quantize_params`' layout, one
    (K, N) matrix (one expert's) at a time on ``device``: a full-width
    model never holds its float banks beside the quantized ones."""
    device = default_device(device, "build MLA params")
    quantize = quantize_q4 if bits == 4 else quantize_q8

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def build(name, lead, kk, nn):
        if name not in _QUANTIZABLE:
            return (normal((*lead, kk, nn)) / math.sqrt(kk)).to(dtype)
        g = group_for(kk, group, bits)
        return quantized_stack(lead, lambda: quantize(
            normal((kk, nn)) / math.sqrt(kk), g))

    parts = _tree(cfg, build, dtype, device)
    return {"tok_emb": (normal((cfg.vocab_size, cfg.dim)) * 0.02).to(dtype),
            **parts,
            "out_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
            "lm_head": quantize(normal((cfg.dim, cfg.vocab_size))
                                / math.sqrt(cfg.dim),
                                group_for(cfg.dim, group, bits))}


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    group: int = 64) -> Dict[str, Any]:
    """Quantize the big MLA matrices at Q4 or Q8 (expert banks one expert
    at a time) and ``lm_head``, each at :func:`group_for`'s group.
    ``wkv_b`` stays in its float dtype: the absorbed decode reads it as the
    per-head K-up and V-up banks. The embedding, the norms, ``wkv_a`` and
    the router keep theirs too."""
    quantize = quantize_q4 if bits == 4 else quantize_q8
    out = dict(params)
    for part in ("attn", "dense_mlp", "moe_mlp"):
        tree = dict(params[part])
        for name in _QUANTIZABLE:
            if name in tree:
                w = tree[name]
                tree[name] = _quantize_stack(
                    w, quantize, group_for(w.shape[-2], group, bits))
        out[part] = tree
    w = params["lm_head"]
    out["lm_head"] = quantize(w, group_for(w.shape[0], group, bits))
    return out


class MLACache(NamedTuple):
    """The compressed latent cache: per layer and token the normed kv
    latent and the rotated shared rope key, updated in place as
    ``models/llm.py``'s KVCache (rows at or past ``length`` are masked);
    ``length`` is a host int."""
    ckv: torch.Tensor   # (L, S_max, r)
    kpe: torch.Tensor   # (L, S_max, rope)
    length: int

    @classmethod
    def create(cls, cfg: MLAConfig, dtype: torch.dtype = torch.bfloat16,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "MLACache":
        """Zeroed rows on ``device``, by default the CUDA card."""
        device = default_device(device, "allocate an MLA cache")
        s = max_seq or cfg.max_seq
        return cls(
            ckv=torch.zeros((cfg.n_layers, s, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
            kpe=torch.zeros((cfg.n_layers, s, cfg.qk_rope_head_dim),
                            dtype=dtype, device=device),
            length=0)


def _rope_freqs(cfg: MLAConfig, device=None) -> torch.Tensor:
    return _rope_freqs_on(cfg.qk_rope_head_dim // 2, cfg.rope_theta,
                          None if device is None else torch.device(device))


def _freqs(params: Dict[str, Any], cfg: MLAConfig, device=None
           ) -> torch.Tensor:
    freqs = _rope_freqs(cfg, device)
    rf = params.get("rope_factors")
    return freqs / rf if rf is not None else freqs


def yarn_rope_factors(cfg: MLAConfig, factor: float, original_max_seq: int,
                      beta_fast: float = 32.0, beta_slow: float = 1.0
                      ) -> torch.Tensor:
    """YaRN divisors over the rope dims, f32 on the CPU: store as
    ``params["rope_factors"]`` for DeepSeek long-context checkpoints.
    Published V2/V3 configs ship ``mscale == mscale_all_dim``, which makes
    the yarn attention factor 1.0, so ``attn_scale_mult`` stays 1."""
    shim = types.SimpleNamespace(head_dim=cfg.qk_rope_head_dim,
                                 rope_theta=cfg.rope_theta)
    return llm_model.yarn_rope_factors(shim, factor, original_max_seq,
                                       beta_fast, beta_slow)


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           freqs: torch.Tensor) -> torch.Tensor:
    """Rotate (S, H, Dr) by adjacent pairs (the DeepSeek convention),
    unlike ``llm.apply_rope``'s split halves."""
    ang = positions[:, None].float() * freqs                  # (S, Dr/2)
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _project_q(h: torch.Tensor, layer, cfg: MLAConfig) -> torch.Tensor:
    """(T, D) -> (T, H, qk_head_dim): full q_proj or the LoRA pair."""
    if cfg.q_lora_rank:
        qa = _rms_norm(_linear(h, layer["wq_a"]), layer["q_a_norm"],
                       cfg.norm_eps)
        q = _linear(qa, layer["wq_b"])
    else:
        q = _linear(h, layer["wq"])
    return q.reshape(h.shape[0], cfg.n_heads, cfg.qk_head_dim)


def _latent(h: torch.Tensor, layer, cfg: MLAConfig, positions: torch.Tensor,
            freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) -> the normed latent (T, r) and the rotated shared rope key
    (T, rope): what the cache stores."""
    ckv = _linear(h, layer["wkv_a"])                          # (T, r+rope)
    c = _rms_norm(ckv[:, :cfg.kv_lora_rank], layer["kv_a_norm"],
                  cfg.norm_eps)
    kpe = apply_rope_interleaved(ckv[:, None, cfg.kv_lora_rank:], positions,
                                 freqs)[:, 0]
    return c, kpe


def _mlp_for(x: torch.Tensor, layer, cfg: MLAConfig,
             dense: bool) -> torch.Tensor:
    if dense:
        return _mlp_block(x, layer["mlp_norm"], layer["w_gu"],
                          layer["w_down"], cfg.norm_eps, act=cfg.act)
    return _moe_block(x, layer, cfg)


def _layer_params(params: Dict[str, Any], cfg: MLAConfig, li: int):
    """Layer ``li``'s views: its attention rows and its dense or MoE MLP
    rows; and whether it is dense."""
    k = _k_dense(cfg)
    dense = li < k
    mlp = (_layer(params["dense_mlp"], li) if dense
           else _layer(params["moe_mlp"], li - k))
    return {**_layer(params["attn"], li), **mlp}, dense


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with f32 sums and an f32 result, as
    the reference's einsums of both operands widened to f32. On the card a
    bf16 ``b`` (the latent cache, ``wkv_b``'s banks) is read as stored: a
    bf16 ``a`` takes one product, an f32 ``a`` two (its bf16 head and the
    bf16 rounding of its remainder), each exact in f32. Elsewhere both
    operands widen to f32."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if not (is_cuda(a) and b.dtype == torch.bfloat16):
        return torch.matmul(a.float(), b.float())
    if a.dtype == torch.bfloat16:
        return mm(a, b, out_dtype=torch.float32)
    a = a.float()
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return (mm(hi, b, out_dtype=torch.float32)
            + mm(lo, b, out_dtype=torch.float32))


def _absorbed(q_nope: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
              kpe: torch.Tensor, mask: torch.Tensor, neg: float, layer,
              cfg: MLAConfig) -> torch.Tensor:
    """The absorbed attention of T query rows against one latent cache:
    q_nope (T, H, nope), q_pe (T, H, rope), ckv (S, r), kpe (S, rope), mask
    (T, S) True where a key is visible (``neg`` elsewhere). Returns the
    (T, H * v) f32 output before ``wo``."""
    t, hh = q_nope.shape[0], cfg.n_heads
    nope, vd, r = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    wkv_b = layer["wkv_b"].reshape(r, hh, nope + vd)
    w_uk = wkv_b[..., :nope].permute(1, 2, 0)                 # (H, nope, r)
    w_uv = wkv_b[..., nope:].permute(1, 0, 2)                 # (H, r, v)
    q_abs = _dot_f32(q_nope.transpose(0, 1), w_uk)            # (H, T, r)
    scores = (_dot_f32(q_abs.reshape(hh * t, r), ckv.t())
              + _dot_f32(q_pe.transpose(0, 1).reshape(hh * t, -1), kpe.t())
              ) * cfg.attn_scale                              # (H*T, S)
    scores = scores.reshape(hh, t, -1)
    scores = torch.where(mask[None], scores, neg)
    w = torch.softmax(scores, dim=-1)
    out_c = _dot_f32(w.reshape(hh * t, -1), ckv).reshape(hh, t, r)
    out = _dot_f32(out_c, w_uv)                               # (H, T, v)
    return out.transpose(0, 1).reshape(t, hh * vd)


def _output_logits(params, cfg: MLAConfig, x: torch.Tensor) -> torch.Tensor:
    return _linear(_rms_norm(x, params["out_norm"], cfg.norm_eps),
                   params["lm_head"]).float()


@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: MLAConfig, tokens: torch.Tensor,
            length: int, cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """Prompt pass over a padded bucket (S_pad,): decompressed attention
    (V zero-padded to ``qk_head_dim``; the flash kernel at head dim 192 on
    the card at S >= 256), the latent written to rows [0, S_pad) in place.
    Returns the logits of token ``length - 1`` and the cache at
    ``length``; rows past it hold garbage the mask hides."""
    s_pad = tokens.shape[0]
    device = tokens.device
    freqs = _freqs(params, cfg, device)
    positions = torch.arange(s_pad, device=device)
    x = embed_tokens(params, tokens)                      # (S, D)
    hh, nope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    for li in range(cfg.n_layers):
        layer, dense = _layer_params(params, cfg, li)
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _project_q(h, layer, cfg)                         # (S, H, qk)
        q = torch.cat([q[..., :nope], apply_rope_interleaved(
            q[..., nope:], positions, freqs)], dim=-1)
        c, kpe = _latent(h, layer, cfg, positions, freqs)
        cache.ckv[li, :s_pad] = c.to(cache.ckv.dtype)
        cache.kpe[li, :s_pad] = kpe.to(cache.kpe.dtype)
        kv = _linear(c, layer["wkv_b"]).reshape(s_pad, hh, nope + vd)
        k = torch.cat([kv[..., :nope], kpe[:, None, :].expand(
            s_pad, hh, cfg.qk_rope_head_dim)], dim=-1)        # (S, H, qk)
        v_pad = F.pad(kv[..., nope:], (0, cfg.qk_head_dim - vd))
        attn = prefill_attention(
            q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
            v_pad.transpose(0, 1).contiguous(), causal=True,
            scale=cfg.attn_scale).transpose(0, 1)[..., :vd]
        x = x + _linear(attn.reshape(s_pad, hh * vd).to(x.dtype),
                        layer["wo"])
        x = _mlp_for(x, layer, cfg, dense)
    logits = _output_logits(params, cfg, x[max(length - 1, 0)][None])[0]
    return logits, MLACache(cache.ckv, cache.kpe, int(length))


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: MLAConfig, token,
                cache: MLACache, attn_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, MLACache]:
    """One absorbed decode step at position ``cache.length`` (the token an
    int or a 0-d device tensor): writes its latent row in place, returns
    the logits and the cache at length + 1. Exactly the decompressed form,
    since the kv norm sits before ``wkv_b``."""
    pos = cache.length
    device = cache.ckv.device
    freqs = _freqs(params, cfg, device)
    positions = torch.arange(pos, pos + 1, device=device)
    x = embed_token(params, token)                            # (1, D)
    nope = cfg.qk_nope_head_dim
    s_len = attn_len or cache.ckv.shape[1]
    mask = torch.arange(s_len, device=device)[None] <= pos    # (1, S)
    for li in range(cfg.n_layers):
        layer, dense = _layer_params(params, cfg, li)
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _project_q(h, layer, cfg)                         # (1, H, qk)
        q_pe = apply_rope_interleaved(q[..., nope:], positions, freqs)
        c, kpe = _latent(h, layer, cfg, positions, freqs)
        cache.ckv[li, pos] = c[0].to(cache.ckv.dtype)
        cache.kpe[li, pos] = kpe[0].to(cache.kpe.dtype)
        out = _absorbed(q[..., :nope], q_pe, cache.ckv[li, :s_len],
                        cache.kpe[li, :s_len], mask, float("-inf"), layer,
                        cfg)
        x = x + _linear(out.to(x.dtype), layer["wo"])
        x = _mlp_for(x, layer, cfg, dense)
    logits = _output_logits(params, cfg, x)[0]
    return logits, MLACache(cache.ckv, cache.kpe, pos + 1)


@torch.no_grad()
def extend(params: Dict[str, Any], cfg: MLAConfig, tokens: torch.Tensor,
           n_valid: int, cache: MLACache, attn_len: Optional[int] = None,
           all_logits: bool = False) -> Tuple[torch.Tensor, MLACache]:
    """Append a padded chunk after ``cache.length`` with the absorbed form
    over the whole chunk (chunked prefill, tool re-injection, the
    speculative verify pass with ``all_logits``): the chunk's queries
    score the latent prefix and causally within the chunk. Padded rows that
    would fall past S_max are dropped (the valid ones must fit)."""
    offset = cache.length
    b = tokens.shape[0]
    s_max = cache.ckv.shape[1]
    if offset + n_valid > s_max:
        raise ValueError(f"extend past the cache: {offset} + {n_valid} > "
                         f"{s_max}")
    fit = min(b, s_max - offset)
    device = tokens.device
    freqs = _freqs(params, cfg, device)
    positions = offset + torch.arange(b, device=device)
    x = embed_tokens(params, tokens)                      # (B, D)
    nope = cfg.qk_nope_head_dim
    s_len = attn_len or s_max
    mask = (torch.arange(s_len, device=device)[None, :]
            <= positions[:, None])                            # (B, S)
    for li in range(cfg.n_layers):
        layer, dense = _layer_params(params, cfg, li)
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _project_q(h, layer, cfg)                         # (B, H, qk)
        q_pe = apply_rope_interleaved(q[..., nope:], positions, freqs)
        c, kpe = _latent(h, layer, cfg, positions, freqs)
        cache.ckv[li, offset:offset + fit] = c[:fit].to(cache.ckv.dtype)
        cache.kpe[li, offset:offset + fit] = kpe[:fit].to(cache.kpe.dtype)
        out = _absorbed(q[..., :nope], q_pe, cache.ckv[li, :s_len],
                        cache.kpe[li, :s_len], mask, -1e30, layer, cfg)
        x = x + _linear(out.to(x.dtype), layer["wo"])
        x = _mlp_for(x, layer, cfg, dense)
    final = MLACache(cache.ckv, cache.kpe, offset + int(n_valid))
    if all_logits:
        return _output_logits(params, cfg, x), final
    return _output_logits(params, cfg, x[max(n_valid - 1, 0)][None])[0], final


@torch.no_grad()
def decode_chunk_greedy(params: Dict[str, Any], cfg: MLAConfig,
                        logits: torch.Tensor, cache: MLACache, n_tokens: int,
                        attn_len: Optional[int] = None,
                        eos_id: Optional[int] = None,
                        suppress_until: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, MLACache]:
    """``n_tokens`` greedy steps from a logits vector, the argmax kept on
    the device: ``models/llm.py:decode_chunk_greedy``'s contract (the
    caller rolls ``cache.length`` back on a terminal token)."""
    toks = []
    lg = logits
    for step in range(n_tokens):
        if eos_id is not None and step < suppress_until:
            lg = lg.clone()
            lg[eos_id] = -1e30
        tok = torch.argmax(lg)
        toks.append(tok)
        lg, cache = decode_step(params, cfg, tok, cache, attn_len=attn_len)
    return torch.stack(toks), lg, cache


# ---------------------------------------------------------------------------
# Batched decode (the continuous-batching server)
# ---------------------------------------------------------------------------

class BatchedMLACache(NamedTuple):
    """Per-slot latent caches for the server, in place as
    ``llm.BatchedKVCache``: (r + rope) values a token and layer.
    ``lengths`` is a (B,) int32 tensor on the caches' device."""
    ckv: torch.Tensor      # (L, B, S, r)
    kpe: torch.Tensor      # (L, B, S, rope)
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg: MLAConfig, batch: int,
               dtype: torch.dtype = torch.bfloat16,
               max_seq: Optional[int] = None,
               device: Optional[torch.device] = None) -> "BatchedMLACache":
        device = default_device(device, "allocate an MLA cache")
        s = max_seq or cfg.max_seq
        return cls(
            ckv=torch.zeros((cfg.n_layers, batch, s, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
            kpe=torch.zeros((cfg.n_layers, batch, s, cfg.qk_rope_head_dim),
                            dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


@torch.no_grad()
def insert_sequence(cache: BatchedMLACache, cfg: MLAConfig, slot: int,
                    seq_cache: MLACache) -> BatchedMLACache:
    """Copy a single sequence's latent cache into slot ``slot`` in place."""
    s = seq_cache.ckv.shape[1]
    cache.ckv[:, slot, :s] = seq_cache.ckv.to(cache.ckv.dtype)
    cache.kpe[:, slot, :s] = seq_cache.kpe.to(cache.kpe.dtype)
    cache.lengths[slot] = int(seq_cache.length)
    return cache


@torch.no_grad()
def decode_step_batch(params: Dict[str, Any], cfg: MLAConfig,
                      tokens: torch.Tensor, active: torch.Tensor,
                      cache: BatchedMLACache,
                      attn_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, BatchedMLACache]:
    """One absorbed decode step for every slot: tokens (B,) -> logits
    (B, V). Inactive slots compute but write nothing and do not advance;
    each slot's scores read its own latent."""
    b = tokens.shape[0]
    device = tokens.device
    pos = cache.lengths.long()
    rows = torch.arange(b, device=device)
    wpos = pos.clamp_max(cache.ckv.shape[2] - 1)
    freqs = _freqs(params, cfg, device)
    x = embed_tokens(params, tokens)                      # (B, D)
    nope = cfg.qk_nope_head_dim
    s_len = attn_len or cache.ckv.shape[2]
    mask = (torch.arange(s_len, device=device)[None, :]
            <= pos[:, None])                                  # (B, S)
    for li in range(cfg.n_layers):
        layer, dense = _layer_params(params, cfg, li)
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _project_q(h, layer, cfg)                         # (B, H, qk)
        q_pe = apply_rope_interleaved(q[..., nope:], pos, freqs)
        c, kpe = _latent(h, layer, cfg, pos, freqs)
        _write_rows(cache.ckv[li], rows, wpos, c, active)
        _write_rows(cache.kpe[li], rows, wpos, kpe, active)
        outs = [_absorbed(q[i:i + 1, :, :nope], q_pe[i:i + 1],
                          cache.ckv[li, i, :s_len], cache.kpe[li, i, :s_len],
                          mask[i:i + 1], float("-inf"), layer, cfg)
                for i in range(b)]
        x = x + _linear(torch.cat(outs).to(x.dtype), layer["wo"])
        x = _mlp_for(x, layer, cfg, dense)
    logits = _output_logits(params, cfg, x)
    lengths = torch.where(active, cache.lengths + 1, cache.lengths)
    return logits, BatchedMLACache(cache.ckv, cache.kpe, lengths)


@torch.no_grad()
def decode_steps_batch(params: Dict[str, Any], cfg: MLAConfig,
                       tokens: torch.Tensor, active: torch.Tensor,
                       cache: BatchedMLACache, n_steps: int,
                       attn_len: Optional[int] = None
                       ) -> Tuple[torch.Tensor, BatchedMLACache]:
    """``n_steps`` greedy batch steps with each argmax fed back on the
    device; returns ((n_steps, B) tokens, cache)."""
    produced = []
    toks = tokens
    for _ in range(n_steps):
        logits, cache = decode_step_batch(params, cfg, toks, active, cache,
                                          attn_len=attn_len)
        toks = torch.argmax(logits, dim=-1)
        produced.append(toks)
    return torch.stack(produced), cache


# The runner and the server drive any module with this surface (their
# ``model=``); MLACache and BatchedMLACache play the KV caches' roles.
KVCache = MLACache
BatchedKVCache = BatchedMLACache
