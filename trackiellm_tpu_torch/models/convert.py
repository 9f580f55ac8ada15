"""Checkpoint conversion: GGUF (llama.cpp) -> this package's LLM params.

Port of the GGUF route of ``trackiellm_tpu/models/convert.py``: the
product ships its LLM as a llama.cpp GGUF file (a Mistral-7B GGUF), and
this module turns that file into the native parameter tree (fused QKV and
gate+up, stacked layers, optional Q4/Q8 group requantization), which
``models/checkpoint.py`` saves in the format both packages read.

llama.cpp tensor naming (converted by this module):
  token_embd.weight                 -> tok_emb
  blk.{i}.attn_norm.weight          -> layers.attn_norm[i]
  blk.{i}.attn_{q,k,v}.weight       -> layers.wqkv[i] (fused, transposed)
  blk.{i}.attn_output.weight        -> layers.wo[i]
  blk.{i}.ffn_norm.weight           -> layers.mlp_norm[i]
  blk.{i}.ffn_{gate,up}.weight      -> layers.w_gu[i] (fused)
  blk.{i}.ffn_down.weight           -> layers.w_down[i]
  output_norm.weight                -> out_norm
  output.weight                     -> lm_head (falls back to tok_emb.T
                                      for tied-embedding models)

GGUF stores weights as (out, in); this package computes x @ W with
W (in, out), so every matrix is transposed during conversion.

Reading the file and dequantizing GGML blocks is host numpy code
(``models/loader.py``), as in the reference. The requantization runs on
the ``device`` given, the CUDA card by default, through
``ops/quant.py``'s quantizers, which give the JAX package's bytes on the
card and on the CPU. The arches with converters of their own (MLA, Mamba,
Falcon, Llama-4, GLM-4-MoE, Qwen3-Next) and the transformers-state-dict
routes are not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from trackiellm_tpu_torch.llm.tokenizer import tokenizer_from_spec
from trackiellm_tpu_torch.models import llm as llm_model
from trackiellm_tpu_torch.models.loader import (
    GGUFFile,
    load_gguf_tensor,
    read_gguf_header,
)
from trackiellm_tpu_torch.ops.quant import (QuantizedLinear, quantize_q4,
                                            quantize_q8)
from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("models.convert")

# GGUF arches that the JAX package converts with a route of their own.
_WAITING_ARCHES = {
    "deepseek2": "gguf_to_mla_params", "mamba": "gguf_to_mamba_params",
    "falcon": "gguf_to_falcon_params", "llama4": "gguf_to_llama4_params",
    "glm4moe": "gguf_to_glm4moe_params",
    "qwen3next": "gguf_to_qwen3next_params",
}


def _math_key(md: Dict[str, Any], name: str, default,
              heuristic: str = ""):
    """Read a GGUF metadata key whose value changes the math (gating
    function, QK-norm presence, weight-norm flags): an absent key defaults
    by heuristic with a loud warning, and ``TRACKIE_GGUF_STRICT=1`` turns
    the guess into a hard failure. The routes that read such keys wait for
    ROADMAP Queue 1 item 11."""
    if name in md:
        return md[name]
    why = f" ({heuristic})" if heuristic else ""
    if os.environ.get("TRACKIE_GGUF_STRICT", "0") == "1":
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"GGUF lacks math-bearing key {name}; refusing to default "
            f"to {default!r}{why} under TRACKIE_GGUF_STRICT=1")
    log.warning("GGUF lacks math-bearing key %s; defaulting to %r%s — "
                "verify against the publisher (TRACKIE_GGUF_STRICT=1 "
                "to fail instead)", name, default, why)
    return default


def config_from_gguf(gguf: GGUFFile) -> llm_model.LLMConfig:
    """Derive an LLMConfig from GGUF metadata (llama.cpp key names)."""
    md = gguf.metadata
    arch = gguf.architecture or "llama"

    def key(suffix: str, default=None):
        v = md.get(f"{arch}.{suffix}", default)
        if v is None:
            raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                               f"missing GGUF key {arch}.{suffix}")
        return v

    n_heads = int(key("attention.head_count"))
    dim = int(key("embedding_length"))
    # head_dim is decoupled from dim//n_heads in some families (the
    # llama.cpp key is {arch}.attention.key_length); Qwen2-style QKV
    # projection biases are detected from tensor presence, exactly how
    # llama.cpp decides (optional-tensor lookup, not metadata).
    head_dim = int(md.get(f"{arch}.attention.key_length",
                          dim // n_heads))
    qkv_bias = "blk.0.attn_q.bias" in gguf.tensors
    # Qwen3 per-head QK RMSNorm: detected from tensor presence like the
    # biases (llama.cpp's build_qwen3 loads attn_{q,k}_norm the same way).
    qk_norm = "blk.0.attn_q_norm.weight" in gguf.tensors
    # Gemma-2: GeGLU, sandwich norms, softcaps, alternating local
    # windows. GGUF stores the softcaps as metadata; the (1+w) norm
    # convention is already folded by the official conversion script
    # (convert_hf_to_gguf adds 1 to every *norm.weight), and the
    # sqrt(dim) embedding scale is folded below in gguf_to_llm_params.
    gemma2 = arch == "gemma2"
    extra = {}
    if arch == "olmo2":
        # OLMo-2 (llama.cpp LLM_ARCH_OLMO2): post-norm-only placement
        # (no attn_norm/ffn_norm tensors; post_attention_norm /
        # post_ffw_norm instead) and Q/K RMSNorm over the WHOLE
        # projection — the attn_{q,k}_norm tensors exist but are
        # (H*Dh,), so the per-head qk_norm detection above must yield
        # to qk_norm_full.
        qk_norm = False
        extra = dict(pre_norms=False, post_norms=True, qk_norm_full=True)
    if arch in ("granite", "granitemoe"):
        # Granite (llama.cpp LLM_ARCH_GRANITE): Llama-shaped + scalar
        # multipliers in metadata. attention.scale IS the score scale
        # -> query_pre_attn_scalar = scale**-2; residual_scale is the
        # runtime knob; embedding/logit scales fold in
        # gguf_to_llm_params.
        extra = dict(residual_multiplier=float(
            md.get(f"{arch}.residual_scale", 1.0)))
        attn_scale = float(md.get(f"{arch}.attention.scale", 0.0) or 0.0)
        if attn_scale:
            extra["query_pre_attn_scalar"] = float(attn_scale ** -2)
    if arch == "nemotron":
        # Nemotron (llama.cpp LLM_ARCH_NEMOTRON): LayerNorm1p (the 1+w
        # fold is baked by convert_hf_to_gguf, biases ship as tensors),
        # ungated squared-ReLU MLP, partial split-half rope.
        rot = int(md.get(f"{arch}.rope.dimension_count", head_dim // 2))
        extra = dict(norm_type="layernorm", mlp_gated=False,
                     act="relu2",
                     partial_rotary_factor=rot / head_dim)
    if arch == "starcoder2":
        # StarCoder2 (llama.cpp LLM_ARCH_STARCODER2): LayerNorm with
        # biases everywhere — attention projections (qkv_bias detected
        # from tensors above), o_proj, and the ungated GELU MLP.
        extra = dict(norm_type="layernorm", mlp_gated=False,
                     act="gelu", mlp_bias=True,
                     out_bias="blk.0.attn_output.bias" in gguf.tensors)
    if arch in ("command-r", "cohere2"):
        # Cohere (llama.cpp LLM_ARCH_COMMAND_R / COHERE2): bias-free
        # LayerNorm + parallel residual + interleaved rope (type NORM,
        # folded below) + logit_scale MULTIPLIER (folded into lm_head).
        # Cohere2's sliding_window_pattern: every pattern-th layer is
        # global AND NoPE (rope only on sliding layers).
        extra = dict(norm_type="layernorm", parallel_residual=True)
        pattern = int(md.get(f"{arch}.attention.sliding_window_pattern",
                             0) or 0)
        if pattern > 1:
            extra.update(window_pattern=pattern, nope_pattern=pattern)
    if arch == "glm4":
        # GLM-4 (llama.cpp LLM_ARCH_GLM4): sandwich norms (Gemma-2
        # tensor names) + half-width INTERLEAVED rope (llama.cpp rope
        # type NORM; rope.dimension_count carries the rotary width).
        # The interleave itself is folded by gguf_to_llm_params via a
        # q/k column permutation.
        rot = int(md.get(f"{arch}.rope.dimension_count", head_dim // 2))
        extra = dict(
            post_norms="blk.0.post_attention_norm.weight" in gguf.tensors,
            partial_rotary_factor=rot / head_dim)
    if arch == "gpt-oss":
        # gpt-oss (llama.cpp LLM_ARCH_GPT_OSS; arch string per the
        # llama.cpp convention of hyphenated HF names): attention
        # sinks + biases everywhere (detected from tensors), clamped
        # SwiGLU ("gptoss" act), softmax-AFTER-top-k router with bias,
        # alternating sliding/full layers. The key strings follow
        # llama.cpp's conventions; geometry cross-checks fail loudly on
        # a mismatch.
        extra = dict(alt_window=True, moe_score_func="softmax_topk",
                     act="gptoss",
                     moe_bias="blk.0.ffn_gate_inp.bias" in gguf.tensors,
                     attn_sinks="blk.0.attn_sinks.weight" in gguf.tensors
                     or "blk.0.attn_sinks" in gguf.tensors,
                     out_bias="blk.0.attn_output.bias" in gguf.tensors)
    if arch == "smollm3":
        # SmolLM3 (llama.cpp LLM_ARCH_SMOLLM3): Llama-shaped with NoPE
        # every interval-th layer; llama.cpp hardcodes the published
        # interval of 4 when the key is absent.
        extra = dict(nope_pattern=int(md.get(
            f"{arch}.no_rope_layer_interval", 4)))
    if arch == "gemma3":
        # Gemma-3 (llama.cpp LLM_ARCH_GEMMA3): GeGLU + sandwich norms
        # like Gemma-2, no softcaps (per-head QK norms instead —
        # detected from tensor presence above), a FIXED 5:1
        # sliding/global pattern, and a dual rope: sliding layers at
        # the local base (llama.cpp hardcodes 10k when the key is
        # absent), global layers at rope.freq_base with the generic
        # linear/yarn scaling below. Published query scalars: 256
        # (1B/4B/12B, = head_dim), dim/n_heads = 168 for 27B.
        qpas_default = float(head_dim if dim < 5376 else dim // n_heads)
        extra = dict(
            act="gelu",
            post_norms="blk.0.post_attention_norm.weight" in gguf.tensors,
            query_pre_attn_scalar=float(md.get(
                f"{arch}.attention.query_pre_attention_scalar",
                qpas_default)),
            window_pattern=6,
            rope_local_theta=float(md.get(
                f"{arch}.rope.local_freq_base", 10000.0)),
        )
    if gemma2:
        # query_pre_attn_scalar is not a GGUF key (llama.cpp derives
        # the scale from the model type): published sizes use
        # head_dim (2B/9B: 256) except 27B, which uses
        # dim/n_heads (4608/32 = 144).
        qpas_default = float(head_dim if dim < 4608 else dim // n_heads)
        extra = dict(
            act="gelu",
            post_norms="blk.0.post_attention_norm.weight" in gguf.tensors,
            attn_softcap=float(md.get(f"{arch}.attn_logit_softcapping",
                                      50.0)),
            logit_softcap=float(md.get(f"{arch}.final_logit_softcapping",
                                       30.0)),
            query_pre_attn_scalar=float(md.get(
                f"{arch}.attention.query_pre_attention_scalar",
                qpas_default)),
            alt_window=True,
        )
    # Phi-3 longrope: original context + attention factor (llama.cpp
    # stores the factor sets as rope_factors_{short,long}.weight
    # tensors, loaded by gguf_to_llm_params).
    orig_ctx = int(md.get(f"{arch}.rope.scaling.original_context_length",
                          0))
    if orig_ctx and "rope_factors_long.weight" in gguf.tensors:
        import math as _math

        max_ctx = int(key("context_length", 4096))
        att = float(md.get(
            f"{arch}.rope.scaling.attn_factor",
            _math.sqrt(1.0 + _math.log(max_ctx / orig_ctx)
                       / _math.log(orig_ctx))))
        extra.update(rope_original_max_seq=orig_ctx,
                     rope_attention_factor=att)
    # YaRN context extension (rope.scaling.type=yarn — Qwen/DeepSeek
    # long-context GGUFs): llama.cpp derives freq_scale = 1/factor and
    # an attention mscale from the same keys; here the per-frequency
    # divisors are computed into params["rope_factors"] by
    # gguf_to_llm_params and the mscale rides cfg.rope_attention_factor
    # (attn_factor metadata multiplies it, llama.cpp's convention).
    stype = str(md.get(f"{arch}.rope.scaling.type", "") or "")
    sfactor = float(md.get(f"{arch}.rope.scaling.factor", 0.0) or 0.0)
    if stype == "yarn" and sfactor > 1.0:
        attf = float(md.get(f"{arch}.rope.scaling.attn_factor", 1.0))
        extra.update(
            rope_original_max_seq=orig_ctx,
            rope_attention_factor=attf
            * llm_model.yarn_attention_factor(sfactor))
    return llm_model.LLMConfig(
        vocab_size=int(md.get("tokenizer.ggml.tokens_count",
                              md.get(f"{arch}.vocab_size",
                                     gguf.tensors["token_embd.weight"]
                                     .shape[0]))),
        dim=dim,
        n_layers=int(key("block_count")),
        n_heads=n_heads,
        n_kv_heads=int(key("attention.head_count_kv", n_heads)),
        head_dim=head_dim,
        hidden_dim=int(md.get(f"{arch}.expert_feed_forward_length",
                           key("feed_forward_length"))),
        norm_eps=float(md.get(
            f"{arch}.attention.layer_norm_rms_epsilon",
            md.get(f"{arch}.attention.layer_norm_epsilon", 1e-5))),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        max_seq=int(key("context_length", 4096)),
        sliding_window=int(md.get(f"{arch}.attention.sliding_window",
                                  key("context_length", 4096))),
        qkv_bias=qkv_bias,
        qk_norm=qk_norm,
        n_experts=int(md.get(f"{arch}.expert_count", 0)),
        n_experts_used=int(md.get(f"{arch}.expert_used_count", 2)),
        # Qwen2-MoE (llama.cpp arch "qwen2moe"): the shared expert has
        # its own size key, and top-k weights are NOT renormalized
        # (llama.cpp's build_qwen2moe matches).
        moe_shared_hidden=int(md.get(
            f"{arch}.expert_shared_feed_forward_length", 0)),
        # No top-k renormalization: Qwen2-MoE (raw softmax slices) and
        # gpt-oss (softmax over the kept top-k only — combined with
        # moe_score_func="softmax_topk" above).
        moe_norm_topk=arch not in ("qwen2moe", "gpt-oss"),
        **extra,
    )


def tokenizer_spec_from_gguf(gguf: GGUFFile):
    """JSON-serializable tokenizer description from GGUF metadata —
    persisted into native checkpoints so a converted model rebuilds the
    same tokenizer with no extra file. None when no vocab."""
    md = gguf.metadata
    tokens = md.get("tokenizer.ggml.tokens")
    if not tokens:
        return None
    if md.get("tokenizer.ggml.model") == "gpt2":
        return {"model": "gpt2",
                "tokens": list(tokens),
                "merges": list(md.get("tokenizer.ggml.merges", [])),
                "pre": str(md.get("tokenizer.ggml.pre", "llama-bpe")),
                "token_types": md.get("tokenizer.ggml.token_type"),
                "bos_id": int(md.get("tokenizer.ggml.bos_token_id", 0)),
                "eos_id": int(md.get("tokenizer.ggml.eos_token_id", 0)),
                "pad_id": int(md.get("tokenizer.ggml.padding_token_id",
                                     0))}
    return {"model": "spm",
            "tokens": list(tokens),
            "scores": md.get("tokenizer.ggml.scores"),
            "token_types": md.get("tokenizer.ggml.token_type"),
            "pad_id": int(md.get("tokenizer.ggml.padding_token_id", 0)),
            "add_space_prefix": bool(md.get(
                "tokenizer.ggml.add_space_prefix", True))}


def tokenizer_from_gguf(gguf: GGUFFile):
    """The tokenizer of the GGUF's embedded vocabulary (SentencePiece
    score-merge BPE, or byte-level BPE for "gpt2" files), or None when the
    file carries no vocab."""
    spec = tokenizer_spec_from_gguf(gguf)
    return None if spec is None else tokenizer_from_spec(spec)


def _deinterleave_rope_cols(w: np.ndarray, n_heads: int, head_dim: int,
                            rotary_dim: int) -> np.ndarray:
    """Permute a q/k projection from the INTERLEAVED rope layout (pairs
    (2i, 2i+1) rotate together: llama.cpp's NORM rope, GLM, Cohere) to
    this package's split-half layout (pairs (i, R/2+i)). Applying the
    same permutation to q and k leaves attention scores untouched, so the
    fold is exact.

    ``w``: (in, H*hd) projection (already transposed) or (H*hd,) bias."""
    shape = w.shape
    cols = w.reshape(shape[:-1] + (n_heads, head_dim))
    rot, rest = cols[..., :rotary_dim], cols[..., rotary_dim:]
    rot = np.concatenate([rot[..., 0::2], rot[..., 1::2]], axis=-1)
    return np.concatenate([rot, rest], axis=-1).reshape(shape)


def _conversion_device(device: Optional[torch.device]) -> torch.device:
    """The device asked for; by default the CUDA card, and with none a
    TrackieError rather than the CPU, which must be asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise TrackieError(
            ErrorCode.DEVICE_UNAVAILABLE,
            "no CUDA device: pass device=torch.device('cpu') to convert on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def gguf_to_llm_params(
    path: str,
    bits: Optional[int] = 4,
    group: int = 256,
    dtype: torch.dtype = torch.bfloat16,
    max_layers: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> tuple:
    """Convert a GGUF checkpoint. Returns (params on ``device``, cfg).

    ``bits``: 4/8 requantizes the big matrices into the kernels' layout on
    ``device``; None (or 0) keeps them in ``dtype``. ``max_layers``
    truncates (for tests and draft models). ``device`` defaults to the
    CUDA card; with no card it raises unless the CPU is asked for.
    The tree, its dtypes and its bytes are those of the JAX package's
    ``gguf_to_llm_params`` on the same file. A config whose knobs the port
    cannot run yet converts all the same and stops at
    ``models/llm.py:check_supported`` when it runs."""
    device = _conversion_device(device)
    gguf = read_gguf_header(path)
    cfg = config_from_gguf(gguf)
    if max_layers is not None:
        cfg = cfg._replace(n_layers=min(cfg.n_layers, max_layers))
    quantize = (quantize_q4 if bits == 4
                else quantize_q8 if bits == 8 else None)

    def tensor(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
        # f32 numpy -> ``dt`` on the device (bf16 rounds to nearest even,
        # as jnp.asarray(a, bf16) does).
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dt)

    def mat(name: str) -> np.ndarray:
        # GGUF (out, in) -> (in, out)
        return np.ascontiguousarray(load_gguf_tensor(gguf, name).T)

    def vec(name: str) -> torch.Tensor:
        return tensor(load_gguf_tensor(gguf, name), dtype)

    def maybe_quant(w: np.ndarray):
        if quantize is None:
            return tensor(w, dtype)
        return quantize(tensor(w, torch.float32), group)

    def stack_q(items):
        return QuantizedLinear(
            values=torch.stack([q.values for q in items]),
            scales=torch.stack([q.scales for q in items]))

    def maybe_quant_experts(w: np.ndarray):
        """(E, K, N) expert bank -> per-expert quantized stack."""
        if quantize is None:
            return tensor(w, dtype)
        return stack_q([quantize(tensor(w[e], torch.float32), group)
                        for e in range(w.shape[0])])

    def stack(items):
        return torch.stack(items) if quantize is None else stack_q(items)

    # Interleaved-rope (llama.cpp rope type NORM) arches: fold the q/k
    # column order to this package's split-half layout (exact; see
    # _deinterleave_rope_cols). GLM-4 rotates half the head; Cohere
    # all of it; and the llama-family arches (llama/mistral/mixtral,
    # granite, smollm3 — everything convert_hf_to_gguf exports through
    # LlamaModel with undo_permute) ship q/k permuted into ggml's NORM
    # pair layout, which this fold inverts.
    # TRACKIE_LLAMA_GGUF_ROPE=hf disables the llama-family fold for
    # GGUFs written directly from HF layout without the permute.
    arch_ = gguf.architecture or ""
    glm_rot = 0
    if arch_ == "glm4":
        glm_rot = int(cfg.head_dim * cfg.partial_rotary_factor)
    elif arch_ in ("command-r", "cohere2"):
        glm_rot = cfg.head_dim
    elif arch_ in ("llama", "granite", "granitemoe", "smollm3"):
        _rope_env = os.environ.get("TRACKIE_LLAMA_GGUF_ROPE", "norm")
        if _rope_env != "hf":
            glm_rot = cfg.head_dim
        # Always say which layout was assumed, so a wrong guess on a
        # non-llama.cpp writer is diagnosable from the log alone:
        # scrambled q/k columns otherwise convert silently.
        log.info(
            "gguf arch=%s: assuming %s q/k rope layout "
            "(TRACKIE_LLAMA_GGUF_ROPE=%s; set =hf for GGUFs written "
            "directly from HF layout without llama.cpp's permute)",
            arch_, "permuted-NORM" if glm_rot else "HF split-half",
            _rope_env)

    wqkv, wo, w_gu, w_down = [], [], [], []
    attn_norm, mlp_norm = [], []
    attn_post_norm, mlp_post_norm = [], []
    q_norm, k_norm = [], []
    qkv_bias = []
    # LayerNorm arches (nemotron/starcoder2) ship norm BIASES as
    # tensors; norm params then become {"g","b"} dicts.
    norm_bias = (cfg.norm_type == "layernorm"
                 and "blk.0.attn_norm.bias" in gguf.tensors)
    attn_norm_b, mlp_norm_b = [], []
    w_gu_b, w_down_b, wo_b = [], [], []
    moe_gate = []
    shared_gu, shared_down, shared_gate = [], [], []
    attn_sink, moe_gate_b = [], []
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        if cfg.pre_norms:
            attn_norm.append(vec(f"{p}.attn_norm.weight"))
            if cfg.parallel_residual:
                # Cohere: ONE shared norm per layer; the sequential
                # helpers never read mlp_norm but the key must exist.
                mlp_norm.append(torch.ones((cfg.dim,), dtype=torch.float32,
                                           device=device))
            else:
                mlp_norm.append(vec(f"{p}.ffn_norm.weight"))
            if norm_bias:
                attn_norm_b.append(vec(f"{p}.attn_norm.bias"))
                mlp_norm_b.append(vec(f"{p}.ffn_norm.bias"))
        if cfg.post_norms:
            # Gemma-2 sandwich norms (llama.cpp tensor names); the
            # (1+w) fold is already baked by convert_hf_to_gguf.
            attn_post_norm.append(vec(f"{p}.post_attention_norm.weight"))
            mlp_post_norm.append(vec(f"{p}.post_ffw_norm.weight"))
        if cfg.qk_norm or cfg.qk_norm_full:
            # Qwen3 per-head / OLMo-2 whole-projection QK norms (the
            # same llama.cpp attn_{q,k}_norm names; the shape differs).
            # The fold permutes, so it commutes with the cast to dtype.
            qn = load_gguf_tensor(gguf, f"{p}.attn_q_norm.weight")
            kn = load_gguf_tensor(gguf, f"{p}.attn_k_norm.weight")
            if glm_rot and qn.size == cfg.n_heads * cfg.head_dim:
                # Cohere per-head norms ride the interleave fold.
                qn = _deinterleave_rope_cols(qn, cfg.n_heads,
                                             cfg.head_dim, glm_rot)
                kn = _deinterleave_rope_cols(kn, cfg.n_kv_heads,
                                             cfg.head_dim, glm_rot)
            q_norm.append(tensor(qn, dtype))
            k_norm.append(tensor(kn, dtype))
        if f"{p}.attn_qkv.weight" in gguf.tensors:
            # Phi-3-style pre-fused QKV ([q; k; v] rows in GGUF ->
            # [q | k | v] columns transposed — exactly this package's
            # wqkv layout).
            qkv = mat(f"{p}.attn_qkv.weight")
        else:
            q_w, k_w = mat(f"{p}.attn_q.weight"), mat(f"{p}.attn_k.weight")
            if glm_rot:
                # interleaved-rope -> split-half column fold.
                q_w = _deinterleave_rope_cols(q_w, cfg.n_heads,
                                              cfg.head_dim, glm_rot)
                k_w = _deinterleave_rope_cols(k_w, cfg.n_kv_heads,
                                              cfg.head_dim, glm_rot)
            qkv = np.concatenate([q_w, k_w,
                                  mat(f"{p}.attn_v.weight")], axis=1)
        if cfg.qkv_bias:
            # Qwen2-style projection biases, fused to match wqkv's
            # [q | k | v] column layout; biases stay high-precision
            # (llama.cpp never quantizes 1-D tensors either).
            q_b = load_gguf_tensor(gguf, f"{p}.attn_q.bias")
            k_b = load_gguf_tensor(gguf, f"{p}.attn_k.bias")
            if glm_rot:
                q_b = _deinterleave_rope_cols(q_b, cfg.n_heads,
                                              cfg.head_dim, glm_rot)
                k_b = _deinterleave_rope_cols(k_b, cfg.n_kv_heads,
                                              cfg.head_dim, glm_rot)
            v_b = load_gguf_tensor(gguf, f"{p}.attn_v.bias")
            qkv_bias.append(tensor(np.concatenate([q_b, k_b, v_b]), dtype))
        wqkv.append(maybe_quant(qkv))
        wo.append(maybe_quant(mat(f"{p}.attn_output.weight")))
        if cfg.out_bias:
            wo_b.append(vec(f"{p}.attn_output.bias"))
        if cfg.attn_sinks:
            # gpt-oss per-head sink logits (llama.cpp attn_sinks;
            # some writers suffix .weight). Kept f32 like the HF route.
            sink = (f"{p}.attn_sinks.weight"
                    if f"{p}.attn_sinks.weight" in gguf.tensors
                    else f"{p}.attn_sinks")
            attn_sink.append(tensor(load_gguf_tensor(gguf, sink),
                                    torch.float32))
        if cfg.n_experts:
            # Mixtral expert banks (llama.cpp 3D tensors, expert-major):
            # ffn_{gate,up}_exps (E, H, D) -> (E, D, 2H) fused;
            # ffn_down_exps (E, D, H) -> (E, H, D); router (E, D) -> (D, E).
            moe_gate.append(tensor(
                load_gguf_tensor(gguf, f"{p}.ffn_gate_inp.weight").T,
                dtype))
            if cfg.moe_bias:
                # gpt-oss: router bias + per-expert projection biases
                # (gate/up fuse to the [gate | up] column layout).
                moe_gate_b.append(vec(f"{p}.ffn_gate_inp.bias"))
                gb = load_gguf_tensor(gguf, f"{p}.ffn_gate_exps.bias")
                ub = load_gguf_tensor(gguf, f"{p}.ffn_up_exps.bias")
                db = load_gguf_tensor(gguf, f"{p}.ffn_down_exps.bias")
                if gb.shape != (cfg.n_experts, cfg.hidden_dim):
                    raise TrackieError(
                        ErrorCode.MODEL_METADATA_INVALID,
                        f"{p}.ffn_gate_exps.bias shape {gb.shape} != "
                        f"(E={cfg.n_experts}, H={cfg.hidden_dim})")
                w_gu_b.append(tensor(np.concatenate([gb, ub], axis=1),
                                     dtype))
                w_down_b.append(tensor(db, dtype))
            g = load_gguf_tensor(gguf, f"{p}.ffn_gate_exps.weight")
            u = load_gguf_tensor(gguf, f"{p}.ffn_up_exps.weight")
            dn = load_gguf_tensor(gguf, f"{p}.ffn_down_exps.weight")
            gu = np.concatenate([g.transpose(0, 2, 1),
                                 u.transpose(0, 2, 1)], axis=2)
            w_gu.append(maybe_quant_experts(np.ascontiguousarray(gu)))
            w_down.append(maybe_quant_experts(
                np.ascontiguousarray(dn.transpose(0, 2, 1))))
            if cfg.moe_shared_hidden:
                # Qwen2-MoE shared expert (llama.cpp *_shexp tensors):
                # ffn_{gate,up}_shexp -> fused (D, 2Hs); ffn_down_shexp
                # -> (Hs, D); scalar gate ffn_gate_inp_shexp -> (D, 1).
                sgu = np.concatenate(
                    [mat(f"{p}.ffn_gate_shexp.weight"),
                     mat(f"{p}.ffn_up_shexp.weight")], axis=1)
                shared_gu.append(maybe_quant(sgu))
                shared_down.append(
                    maybe_quant(mat(f"{p}.ffn_down_shexp.weight")))
                shared_gate.append(tensor(
                    load_gguf_tensor(
                        gguf, f"{p}.ffn_gate_inp_shexp.weight").T, dtype))
        else:
            if f"{p}.ffn_gate.weight" in gguf.tensors:
                gu = np.concatenate([mat(f"{p}.ffn_gate.weight"),
                                     mat(f"{p}.ffn_up.weight")], axis=1)
            else:
                # Phi-3-style pre-fused gate_up ([gate; up] rows).
                gu = mat(f"{p}.ffn_up.weight")
            w_gu.append(maybe_quant(gu))
            w_down.append(maybe_quant(mat(f"{p}.ffn_down.weight")))
            if cfg.mlp_bias:
                w_gu_b.append(vec(f"{p}.ffn_up.bias"))
                w_down_b.append(vec(f"{p}.ffn_down.bias"))
        log.info("converted layer %d/%d", i + 1, cfg.n_layers)

    tok_emb = load_gguf_tensor(gguf, "token_embd.weight")  # (V, D)
    if "output.weight" in gguf.tensors:
        lm_head = mat("output.weight")
    else:  # tied embeddings
        lm_head = np.ascontiguousarray(tok_emb.T)
    if (gguf.architecture or "llama") in ("gemma2", "gemma3"):
        # Gemma scales embeddings by sqrt(dim) at runtime (llama.cpp
        # build_gemma2/3 do the same); fold it into tok_emb AFTER the
        # tied lm_head took the unscaled copy.
        tok_emb = tok_emb * float(np.sqrt(cfg.dim))
    if (gguf.architecture or "llama") in ("command-r", "cohere2"):
        # Cohere MULTIPLIES the logits by logit_scale (llama.cpp
        # build_command_r); fold into lm_head after the tied copy.
        ls = float(gguf.metadata.get(
            f"{gguf.architecture}.logit_scale", 1.0) or 1.0)
        if ls != 1.0:
            lm_head = lm_head * ls
    if (gguf.architecture or "llama") in ("granite", "granitemoe"):
        # Granite's foldable multipliers (llama.cpp applies them at
        # runtime: f_embedding_scale on inpL, f_logit_scale divides
        # the final logits); same unscaled-tied-copy order as Gemma.
        arch0 = gguf.architecture
        emb_scale = float(gguf.metadata.get(
            f"{arch0}.embedding_scale", 1.0) or 1.0)
        logit_scale = float(gguf.metadata.get(
            f"{arch0}.logit_scale", 1.0) or 1.0)
        if emb_scale != 1.0:
            tok_emb = tok_emb * emb_scale
        if logit_scale != 1.0:
            lm_head = lm_head / logit_scale

    layers: Dict[str, Any] = {
        "wqkv": stack(wqkv),
        "wo": stack(wo),
        "w_gu": stack(w_gu),
        "w_down": stack(w_down),
    }
    if cfg.pre_norms:
        if norm_bias:
            layers["attn_norm"] = {"g": torch.stack(attn_norm),
                                   "b": torch.stack(attn_norm_b)}
            layers["mlp_norm"] = {"g": torch.stack(mlp_norm),
                                  "b": torch.stack(mlp_norm_b)}
        else:
            layers["attn_norm"] = torch.stack(attn_norm)
            layers["mlp_norm"] = torch.stack(mlp_norm)
    if cfg.out_bias and wo_b:
        layers["wo_bias"] = torch.stack(wo_b)
    if cfg.mlp_bias:
        layers["w_gu_b"] = torch.stack(w_gu_b)
        layers["w_down_b"] = torch.stack(w_down_b)
    if cfg.qkv_bias:
        layers["wqkv_bias"] = torch.stack(qkv_bias)
    if cfg.post_norms:
        layers["attn_post_norm"] = torch.stack(attn_post_norm)
        layers["mlp_post_norm"] = torch.stack(mlp_post_norm)
    if cfg.qk_norm or cfg.qk_norm_full:
        layers["q_norm"] = torch.stack(q_norm)
        layers["k_norm"] = torch.stack(k_norm)
    if cfg.attn_sinks:
        layers["attn_sink"] = torch.stack(attn_sink)
    if cfg.n_experts:
        layers["moe_gate"] = torch.stack(moe_gate)
        if cfg.moe_bias and moe_gate_b:
            layers["moe_gate_b"] = torch.stack(moe_gate_b)
            layers["w_gu_b"] = torch.stack(w_gu_b)
            layers["w_down_b"] = torch.stack(w_down_b)
        if cfg.moe_shared_hidden:
            layers["shared_gu"] = stack(shared_gu)
            layers["shared_down"] = stack(shared_down)
            layers["shared_gate"] = torch.stack(shared_gate)
    params: Dict[str, Any] = {
        "tok_emb": tensor(tok_emb, dtype),
        "layers": layers,
        "out_norm": ({"g": vec("output_norm.weight"),
                      "b": vec("output_norm.bias")}
                     if norm_bias and "output_norm.bias" in gguf.tensors
                     else vec("output_norm.weight")),
        "lm_head": maybe_quant(lm_head),
    }
    if "rope_freqs.weight" in gguf.tensors:
        # Llama-3.1-style rope scaling: per-frequency divisors baked by
        # convert_hf_to_gguf (llama.cpp applies them identically).
        params["rope_factors"] = tensor(
            load_gguf_tensor(gguf, "rope_freqs.weight"), torch.float32)
    if "rope_factors_long.weight" in gguf.tensors:
        # Phi-3 longrope dual factor sets (llama.cpp tensor names).
        params["rope_factors_short"] = tensor(
            load_gguf_tensor(gguf, "rope_factors_short.weight"),
            torch.float32)
        params["rope_factors_long"] = tensor(
            load_gguf_tensor(gguf, "rope_factors_long.weight"),
            torch.float32)
    if "rope_factors" not in params:
        # Metadata-driven scaling (no baked factor tensor): yarn ramp
        # or uniform linear interpolation — llama.cpp computes both
        # from these keys at rope time; here they become the same
        # static divisor vector the Llama-3.1 path uses.
        md = gguf.metadata
        arch = md["general.architecture"]
        stype = str(md.get(f"{arch}.rope.scaling.type", "") or "")
        sfactor = float(md.get(f"{arch}.rope.scaling.factor", 0.0) or 0.0)
        if stype == "yarn" and sfactor > 1.0:
            orig = int(md.get(
                f"{arch}.rope.scaling.original_context_length",
                cfg.max_seq))
            params["rope_factors"] = llm_model.yarn_rope_factors(
                cfg, sfactor, orig).to(device)
        elif stype == "linear" and sfactor > 1.0:
            params["rope_factors"] = torch.full(
                (cfg.head_dim // 2,), sfactor, dtype=torch.float32,
                device=device)
    return params, cfg


def gguf_convert_auto(path: str, bits: Optional[int] = None,
                      device: Optional[torch.device] = None) -> tuple:
    """The arch -> converter dispatch for GGUF files that the CLI's
    ``convert`` uses (``trackiellm_tpu/models/convert.py:gguf_convert_auto``).
    Returns (params, cfg). The arches with a converter of their own raise
    NotImplementedError naming their ROADMAP item."""
    arch = read_gguf_header(path).architecture or ""
    if arch in _WAITING_ARCHES:
        raise NotImplementedError(
            f"GGUF arch {arch!r}: its converter ({_WAITING_ARCHES[arch]}) "
            "is not ported yet (ROADMAP Queue 1 item 11)")
    return gguf_to_llm_params(path, bits=bits, device=device)
