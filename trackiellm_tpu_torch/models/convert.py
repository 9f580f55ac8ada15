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

The voice converters (``whisper_from_torch``, ``whisper_from_ggml``,
``vad_from_torch``, ``silero_from_onnx``, ``tts_from_torch``,
``vits_from_torch``) and the published-name maps (``apply_name_map``,
``load_name_map`` over ``models/name_maps/``, copies of the JAX package's
``silero_v5``, ``piper_vits`` and ``midas_small`` maps) are ported too,
and so are the vision converters (``detector_from_torch`` for YOLOv8 and
YOLOv5u, ``midas_small_from_torch``, ``ocr_from_torch``,
``dpt_swinv2_from_torch``), which give the vision models' trees in this
package's OIHW layout; each puts its tree on ``device``, the CUDA card by
default.
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
from trackiellm_tpu_torch.ops.backend import default_device
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
    device = default_device(device, "convert")
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


# ---------------------------------------------------------------------------
# Published-name maps
# ---------------------------------------------------------------------------

def apply_name_map(state: Dict[str, Any], mapping: Dict[str, str],
                   strict: bool = False) -> Dict[str, Any]:
    """Rename a published checkpoint's tensors onto the layout a
    ``*_from_torch`` converter expects.

    ``mapping``: {published_name: converter_name}. Names absent from the
    mapping pass through unchanged (strict=True raises instead)."""
    out: Dict[str, Any] = {}
    unmapped = []
    for k, v in state.items():
        if k in mapping:
            out[mapping[k]] = v
        else:
            unmapped.append(k)
            out[k] = v
    if strict and unmapped:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{len(unmapped)} tensors not covered by the name map: "
            f"{unmapped[:8]}...")
    return out


def load_name_map(name_or_path: str) -> Dict[str, str]:
    """Load a name map by file path or by bundled name ('silero_v5',
    'piper_vits', 'midas_small'); keys starting with '_' are comments."""
    import json

    path = name_or_path
    if not os.path.exists(path):
        bundled = os.path.join(os.path.dirname(__file__), "name_maps",
                               f"{name_or_path}.json")
        if os.path.exists(bundled):
            path = bundled
        else:
            raise TrackieError(ErrorCode.FILE_NOT_FOUND,
                               f"name map {name_or_path!r} (not a file, "
                               f"and no bundled map of that name)")
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {k: v for k, v in data.items() if not k.startswith("_")}


# ---------------------------------------------------------------------------
# Voice converters: torch-layout state dicts -> the reference's trees
# ---------------------------------------------------------------------------

def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _on(a, device: torch.device) -> torch.Tensor:
    """An f32 copy of ``a`` on ``device`` (reader arrays may be read-only
    views of the file's bytes)."""
    return torch.tensor(_f32(a), device=device)


def whisper_config_from_torch(state: Dict[str, Any]):
    """Derive a WhisperConfig from checkpoint shapes (standard layout:
    encoder.conv1.weight (d, n_mels, 3), decoder.positional_embedding
    (n_text_ctx, d), head_dim 64 across all published sizes)."""
    from trackiellm_tpu_torch.models.whisper import WhisperConfig

    d, n_mels, _ = np.shape(state["encoder.conv1.weight"])
    n_audio = len({k.split(".")[2] for k in state
                   if k.startswith("encoder.blocks.")})
    n_text = len({k.split(".")[2] for k in state
                  if k.startswith("decoder.blocks.")})
    vocab, _ = np.shape(state["decoder.token_embedding.weight"])
    n_text_ctx, _ = np.shape(state["decoder.positional_embedding"])
    return WhisperConfig(
        n_mels=n_mels, d_model=d, n_heads=max(d // 64, 1),
        n_audio_layers=n_audio, n_text_layers=n_text,
        n_text_ctx=n_text_ctx, vocab_size=vocab)


def _whisper_layer_stack_from_torch(state, prefix: str, n: int,
                                    device: torch.device):
    """Stack n transformer blocks (attn_ln, attn.query/key/value/out with
    biased q/v/out, mlp_ln, mlp.0/mlp.2) into the (n, ...) layout of
    models/whisper; torch linears (out, in) are transposed."""
    def S(fmt, mat=True):
        arrs = [_f32(state[fmt.format(i)]) for i in range(n)]
        return _on(np.stack([a.T if mat else a for a in arrs]), device)

    p = prefix
    return {
        "ln1": S(p + ".{}.attn_ln.weight", False),
        "ln1_b": S(p + ".{}.attn_ln.bias", False),
        "wq": S(p + ".{}.attn.query.weight"),
        "wk": S(p + ".{}.attn.key.weight"),
        "wv": S(p + ".{}.attn.value.weight"),
        "wo": S(p + ".{}.attn.out.weight"),
        "bq": S(p + ".{}.attn.query.bias", False),
        "bv": S(p + ".{}.attn.value.bias", False),
        "bo": S(p + ".{}.attn.out.bias", False),
        "ln2": S(p + ".{}.mlp_ln.weight", False),
        "ln2_b": S(p + ".{}.mlp_ln.bias", False),
        "w1": S(p + ".{}.mlp.0.weight"),
        "b1": S(p + ".{}.mlp.0.bias", False),
        "w2": S(p + ".{}.mlp.2.weight"),
        "b2": S(p + ".{}.mlp.2.bias", False),
    }


def whisper_from_torch(state: Dict[str, Any],
                       device: Optional[torch.device] = None):
    """Standard Whisper checkpoint (torch state-dict arrays) -> (params,
    WhisperConfig) for models/whisper, on ``device`` (the CUDA card by
    default). Linears (out, in) are transposed; conv1ds (out, in, k) become
    (k, in, out). The encoder's sinusoidal buffer is not copied: the model
    computes the same sinusoids."""
    device = default_device(device, "convert")
    cfg = whisper_config_from_torch(state)
    n = cfg.n_text_layers

    def conv(name):
        return _on(_f32(state[name]).transpose(2, 1, 0), device)

    def vec(name):
        return _on(state[name], device)

    def S(fmt, mat=True):
        arrs = [_f32(state[fmt.format(i)]) for i in range(n)]
        return _on(np.stack([a.T if mat else a for a in arrs]), device)

    cb = "decoder.blocks"
    params = {
        "conv1_w": conv("encoder.conv1.weight"),
        "conv1_b": vec("encoder.conv1.bias"),
        "conv2_w": conv("encoder.conv2.weight"),
        "conv2_b": vec("encoder.conv2.bias"),
        "enc": _whisper_layer_stack_from_torch(
            state, "encoder.blocks", cfg.n_audio_layers, device),
        "enc_ln": vec("encoder.ln_post.weight"),
        "enc_ln_b": vec("encoder.ln_post.bias"),
        "tok_emb": vec("decoder.token_embedding.weight"),
        "pos_emb": vec("decoder.positional_embedding"),
        "dec": _whisper_layer_stack_from_torch(state, cb, n, device),
        "cross": {
            "ln": S(cb + ".{}.cross_attn_ln.weight", False),
            "ln_b": S(cb + ".{}.cross_attn_ln.bias", False),
            "wq": S(cb + ".{}.cross_attn.query.weight"),
            "wk": S(cb + ".{}.cross_attn.key.weight"),
            "wv": S(cb + ".{}.cross_attn.value.weight"),
            "wo": S(cb + ".{}.cross_attn.out.weight"),
            "bq": S(cb + ".{}.cross_attn.query.bias", False),
            "bv": S(cb + ".{}.cross_attn.value.bias", False),
            "bo": S(cb + ".{}.cross_attn.out.bias", False),
        },
        "dec_ln": vec("decoder.ln.weight"),
        "dec_ln_b": vec("decoder.ln.bias"),
    }
    return params, cfg


def whisper_from_ggml(path: str, device: Optional[torch.device] = None):
    """whisper.cpp GGML file (the reference's ASR artifact) -> (params on
    ``device``, cfg, tokenizer, mel_filters).

    The GGML container keeps the openai state-dict names, so this is the
    GGML reader feeding :func:`whisper_from_torch`; the file's byte vocab
    becomes a decode-capable tokenizer, and its mel filterbank is returned
    for callers that want the original filters. The shape-derived config
    is checked against the file's hparams: a mismatch means a malformed
    file."""
    from trackiellm_tpu_torch.models.ggml_reader import (
        GGMLVocabTokenizer, read_ggml_whisper)

    g = read_ggml_whisper(path)
    params, cfg = whisper_from_torch(g.tensors, device=device)
    hp = g.hparams
    derived = {"n_mels": cfg.n_mels, "n_audio_layer": cfg.n_audio_layers,
               "n_text_layer": cfg.n_text_layers,
               "n_audio_state": cfg.d_model, "n_text_state": cfg.d_model,
               "n_vocab": cfg.vocab_size, "n_text_ctx": cfg.n_text_ctx}
    for key, ours in derived.items():
        if hp.get(key, ours) != ours:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: hparam {key}={hp[key]} disagrees with tensor "
                f"shapes ({ours})")
    # n_heads is not shape-derivable (head_dim 64 is assumed); the hparams
    # win.
    if hp.get("n_audio_head", cfg.n_heads) != cfg.n_heads:
        cfg = cfg._replace(n_heads=hp["n_audio_head"])
    if hp.get("n_audio_ctx", cfg.n_audio_ctx) != cfg.n_audio_ctx:
        cfg = cfg._replace(n_audio_ctx=hp["n_audio_ctx"])
    return params, cfg, GGMLVocabTokenizer(g.vocab), g.mel_filters


def _lin(state, prefix, device):
    """torch nn.Linear -> {"w": (in, out), "b": (out,)}."""
    return {"w": _on(_f32(state[f"{prefix}.weight"]).T, device),
            "b": _on(state[f"{prefix}.bias"], device)}


def _conv1d_tio(state, prefix, device):
    """torch nn.Conv1d (out, in, k) -> {"w": (k, in, out), "b"}."""
    return {"w": _on(_f32(state[f"{prefix}.weight"]).transpose(2, 1, 0),
                     device),
            "b": _on(state[f"{prefix}.bias"], device)}


def vad_from_torch(state: Dict[str, Any],
                   device: Optional[torch.device] = None):
    """Silero-shape VAD checkpoint (two feature Linears, a GRUCell carrying
    the streaming state, a Linear head: "conv1"/"conv2"/"gru"/"out") ->
    (params, VADConfig) for models/vad, on ``device``. GRUCell's gate order
    r, z, n with separate input/hidden biases is what vad_step computes."""
    from trackiellm_tpu_torch.models.vad import VADConfig

    device = default_device(device, "convert")
    wi = _f32(state["gru.weight_ih"])
    hidden = wi.shape[0] // 3
    n_mels = int(np.shape(state["conv1.weight"])[1])
    conv_ch = int(np.shape(state["conv1.weight"])[0])
    cfg = VADConfig(n_mels=n_mels, conv_ch=conv_ch, hidden=hidden)
    params = {
        "conv1": _lin(state, "conv1", device),
        "conv2": _lin(state, "conv2", device),
        "gru_wi": {"w": _on(wi.T, device),
                   "b": _on(state["gru.bias_ih"], device)},
        "gru_wh": {"w": _on(_f32(state["gru.weight_hh"]).T, device),
                   "b": _on(state["gru.bias_hh"], device)},
        "out": _lin(state, "out", device),
    }
    return params, cfg


def silero_from_onnx(state: Dict[str, Any],
                     device: Optional[torch.device] = None):
    """Published Silero VAD v5 ONNX initializers (with or without the
    ``_model.`` prefix) -> (params, SileroConfig) for
    models/vad.py::SileroVAD, on ``device``."""
    from trackiellm_tpu_torch.models.vad import SileroConfig

    device = default_device(device, "convert")

    def get(name):
        for k in (name, f"_model.{name}"):
            if k in state:
                return _f32(state[k])
        raise KeyError(name)

    basis = get("stft.forward_basis_buffer")
    if basis.ndim == 3:          # (258, 1, 256) conv layout
        basis = basis[:, 0, :]
    enc = [(get(f"encoder.{i}.reparam_conv.weight"),
            get(f"encoder.{i}.reparam_conv.bias")) for i in range(4)]
    wi = get("decoder.rnn.weight_ih")
    cfg = SileroConfig(n_freqs=enc[0][0].shape[1],
                       enc_ch=tuple(w.shape[0] for w, _ in enc),
                       hidden=wi.shape[0] // 4)
    params: Dict[str, Any] = {"stft_basis": _on(basis, device)}
    for i, (w, b) in enumerate(enc):
        params[f"enc{i}_w"] = _on(w, device)
        params[f"enc{i}_b"] = _on(b, device)
    params["lstm_wi"] = _on(wi, device)
    params["lstm_wh"] = _on(get("decoder.rnn.weight_hh"), device)
    params["lstm_bi"] = _on(get("decoder.rnn.bias_ih"), device)
    params["lstm_bh"] = _on(get("decoder.rnn.bias_hh"), device)
    params["head_w"] = _on(get("decoder.decoder.2.weight").reshape(-1),
                           device)
    params["head_b"] = _on(get("decoder.decoder.2.bias").reshape(()),
                           device)
    return params, cfg


def tts_from_torch(state: Dict[str, Any], upsample=(4, 5, 8),
                   device: Optional[torch.device] = None):
    """TTS checkpoint (phoneme Embedding, Conv1d encoder/decoder stacks,
    Linear duration predictor and mel head, Conv1d vocoder, named as
    models/tts's tree) -> (params, TTSConfig), on ``device``."""
    from trackiellm_tpu_torch.models.tts import TTSConfig

    device = default_device(device, "convert")
    emb = _f32(state["emb.weight"])
    n_mels = int(np.shape(state["mel_out.weight"])[0])
    voc_ch = int(np.shape(state["voc_in.weight"])[0])
    cfg = TTSConfig(vocab_size=emb.shape[0], d_model=emb.shape[1],
                    n_mels=n_mels, voc_ch=voc_ch, upsample=tuple(upsample))
    params = {"emb": _on(emb, device)}
    for name in ("enc1", "enc2", "dec1", "dec2", "voc_in", "voc_out"):
        params[name] = _conv1d_tio(state, name, device)
    for name in ("dur1", "dur2", "mel_out"):
        params[name] = _lin(state, name, device)
    for i in range(len(cfg.upsample)):
        for part in (f"voc_up{i}", f"voc_res{i}a", f"voc_res{i}b"):
            params[part] = _conv1d_tio(state, part, device)
    return params, cfg


def _wn_weight(state: Dict[str, Any], prefix: str) -> np.ndarray:
    """Reconstruct a weight-normed conv weight: w = g * v / ||v|| (torch
    weight_norm, dim=0). Falls back to a plain ``.weight``."""
    if f"{prefix}.weight" in state:
        return _f32(state[f"{prefix}.weight"])
    g = _f32(state[f"{prefix}.weight_g"])
    v = _f32(state[f"{prefix}.weight_v"])
    norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(-1))
    return g.reshape(-1, *([1] * (v.ndim - 1))) * v / norm.reshape(
        -1, *([1] * (v.ndim - 1)))


def vits_from_torch(state: Dict[str, Any], max_phonemes: int = 256,
                    max_frames: int = 768, sample_rate: int = 22050,
                    device: Optional[torch.device] = None):
    """Published VITS/Piper checkpoint (torch module names: enc_p.*, dp.*
    stochastic duration predictor, flow.flows.*, dec.* HiFiGAN) ->
    (params, VITSConfig) for models/vits.py::vits_infer, on ``device``.
    Weight-normed convs are rebuilt from weight_g/weight_v on the host, as
    the reference does."""
    from trackiellm_tpu_torch.models.vits import VITSConfig, stack_trees

    device = default_device(device, "convert")

    def A(k):
        return _on(state[k], device)

    def W(prefix):
        return _on(_wn_weight(state, prefix), device)

    emb = _f32(state["enc_p.emb.weight"])
    d_model = emb.shape[1]
    attn_idx = [int(k.split(".")[3]) for k in state
                if k.startswith("enc_p.encoder.attn_layers.")]
    if not attn_idx:
        raise KeyError("enc_p.encoder.attn_layers.* (not a VITS "
                       "checkpoint, or names need a name map)")
    n_layers = max(attn_idx) + 1
    rel = _f32(state["enc_p.encoder.attn_layers.0.emb_rel_k"])
    window = (rel.shape[-2] - 1) // 2
    head_dim = rel.shape[-1]
    n_heads = d_model // head_dim
    ffn_shape = np.shape(state["enc_p.encoder.ffn_layers.0.conv_1.weight"])
    ffn_ch, ffn_kernel = ffn_shape[0], ffn_shape[2]

    layers = []
    for i in range(n_layers):
        ap = f"enc_p.encoder.attn_layers.{i}"
        fp = f"enc_p.encoder.ffn_layers.{i}"
        layers.append({
            "attn": {
                "q_w": A(f"{ap}.conv_q.weight"), "q_b": A(f"{ap}.conv_q.bias"),
                "k_w": A(f"{ap}.conv_k.weight"), "k_b": A(f"{ap}.conv_k.bias"),
                "v_w": A(f"{ap}.conv_v.weight"), "v_b": A(f"{ap}.conv_v.bias"),
                "o_w": A(f"{ap}.conv_o.weight"), "o_b": A(f"{ap}.conv_o.bias"),
                "emb_k": A(f"{ap}.emb_rel_k"),
                "emb_v": A(f"{ap}.emb_rel_v"),
            },
            "ln1_g": A(f"enc_p.encoder.norm_layers_1.{i}.gamma"),
            "ln1_b": A(f"enc_p.encoder.norm_layers_1.{i}.beta"),
            "ffn_w1": A(f"{fp}.conv_1.weight"),
            "ffn_b1": A(f"{fp}.conv_1.bias"),
            "ffn_w2": A(f"{fp}.conv_2.weight"),
            "ffn_b2": A(f"{fp}.conv_2.bias"),
            "ln2_g": A(f"enc_p.encoder.norm_layers_2.{i}.gamma"),
            "ln2_b": A(f"enc_p.encoder.norm_layers_2.{i}.beta"),
        })
    enc = {"layers": stack_trees(layers)}

    # flow: ResidualCouplingLayer at even indices (odd are Flips)
    flow_idx = sorted({int(k.split(".")[2]) for k in state
                       if k.startswith("flow.flows.")
                       and k.split(".")[3] == "pre"})
    wn_layers = max(int(k.split(".")[5]) for k in state
                    if ".enc.in_layers." in k
                    and k.startswith("flow.flows.")) + 1
    wn_kernel = _wn_weight(
        state, f"flow.flows.{flow_idx[0]}.enc.in_layers.0").shape[2]
    couplings = []
    for fi in flow_idx:
        p = f"flow.flows.{fi}"
        wn = {"in_w": [], "in_b": [], "rs_w": [], "rs_b": []}
        for j in range(wn_layers):
            wn["in_w"].append(W(f"{p}.enc.in_layers.{j}"))
            wn["in_b"].append(A(f"{p}.enc.in_layers.{j}.bias"))
            wn["rs_w"].append(W(f"{p}.enc.res_skip_layers.{j}"))
            wn["rs_b"].append(A(f"{p}.enc.res_skip_layers.{j}.bias"))
        couplings.append({
            "pre_w": A(f"{p}.pre.weight"), "pre_b": A(f"{p}.pre.bias"),
            "wn": wn,
            "post_w": A(f"{p}.post.weight"), "post_b": A(f"{p}.post.bias"),
        })
    flow = {"couplings": stack_trees(couplings)}

    # stochastic duration predictor (training-only submodules ignored)
    def dds(prefix, n=3):
        parts = (("sep_w", "convs_sep.{}.weight"),
                 ("sep_b", "convs_sep.{}.bias"),
                 ("pw_w", "convs_1x1.{}.weight"),
                 ("pw_b", "convs_1x1.{}.bias"),
                 ("ln1_g", "norms_1.{}.gamma"), ("ln1_b", "norms_1.{}.beta"),
                 ("ln2_g", "norms_2.{}.gamma"), ("ln2_b", "norms_2.{}.beta"))
        return {ours: torch.stack([A(f"{prefix}." + theirs.format(i))
                                   for i in range(n)])
                for ours, theirs in parts}

    sdp = None
    if "dp.pre.weight" in state:
        cf_idx = sorted({int(k.split(".")[2]) for k in state
                         if k.startswith("dp.flows.")
                         and k.split(".")[3] == "pre"})
        cflows = [{"pre_w": A(f"dp.flows.{fi}.pre.weight"),
                   "pre_b": A(f"dp.flows.{fi}.pre.bias"),
                   "dds": dds(f"dp.flows.{fi}.convs"),
                   "proj_w": A(f"dp.flows.{fi}.proj.weight"),
                   "proj_b": A(f"dp.flows.{fi}.proj.bias")}
                  for fi in cf_idx]
        sdp_ch = np.shape(state["dp.pre.weight"])[0]
        sdp_kernel = np.shape(state["dp.convs.convs_sep.0.weight"])[2]
        sdp_bins = (np.shape(
            state[f"dp.flows.{cf_idx[0]}.proj.weight"])[0] + 1) // 3
        zeros2 = torch.zeros((2,), device=device)
        sdp = {
            "pre_w": A("dp.pre.weight"), "pre_b": A("dp.pre.bias"),
            "dds": dds("dp.convs"),
            "proj_w": A("dp.proj.weight"), "proj_b": A("dp.proj.bias"),
            "flows": stack_trees(cflows),
            "ea_m": A("dp.flows.0.m") if "dp.flows.0.m" in state else zeros2,
            "ea_logs": (A("dp.flows.0.logs") if "dp.flows.0.logs" in state
                        else zeros2.clone()),
        }
        n_sdp_flows = len(cf_idx)
    else:
        sdp_ch, sdp_kernel, sdp_bins, n_sdp_flows = d_model, 3, 10, 4

    # HiFiGAN decoder
    ups = sorted({int(k.split(".")[2]) for k in state
                  if k.startswith("dec.ups.")})
    up_w = [W(f"dec.ups.{i}") for i in ups]
    up_b = [A(f"dec.ups.{i}.bias") if f"dec.ups.{i}.bias" in state
            else torch.zeros((up_w[i].shape[1],), device=device) for i in ups]
    res_flat = sorted({int(k.split(".")[2]) for k in state
                       if k.startswith("dec.resblocks.")})
    n_kernels = len(res_flat) // len(ups)
    resblock_kernels = []
    res = []
    for i in ups:
        level = []
        for j in range(n_kernels):
            p = f"dec.resblocks.{i * n_kernels + j}"
            n_d = len({int(k.split(".")[4]) for k in state
                       if k.startswith(f"{p}.convs1.")})
            c1w = [W(f"{p}.convs1.{d}") for d in range(n_d)]
            if i == 0:
                resblock_kernels.append(c1w[0].shape[2])
            level.append({
                "c1_w": torch.stack(c1w),
                "c1_b": torch.stack([A(f"{p}.convs1.{d}.bias")
                                     for d in range(n_d)]),
                "c2_w": torch.stack([W(f"{p}.convs2.{d}")
                                     for d in range(n_d)]),
                "c2_b": torch.stack([A(f"{p}.convs2.{d}.bias")
                                     for d in range(n_d)]),
            })
        res.append(level)
    up_kernels = tuple(int(w.shape[2]) for w in up_w)
    # The upsample rate is not in the weights; HiFiGAN's convention is
    # k = 2 * rate (the caller can override through VITSConfig).
    up_rates = tuple(max(k // 2, 1) for k in up_kernels)
    # VITS's canonical dilations are (1, 3, 5); shapes cannot tell them
    # apart, so three convs take the canon.
    dilations = tuple(
        tuple(1 + 2 * d for d in range(res[0][j]["c1_w"].shape[0]))
        for j in range(n_kernels))
    dilations = tuple((1, 3, 5) if len(d) == 3 else d for d in dilations)

    cfg = VITSConfig(
        vocab_size=emb.shape[0], d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, ffn_ch=ffn_ch, ffn_kernel=ffn_kernel,
        window=window, n_flows=len(flow_idx), wn_layers=wn_layers,
        wn_kernel=wn_kernel, sdp_ch=sdp_ch, sdp_kernel=sdp_kernel,
        sdp_flows=n_sdp_flows, sdp_bins=sdp_bins,
        up_init_ch=up_w[0].shape[0], upsample_rates=up_rates,
        upsample_kernels=up_kernels,
        resblock_kernels=tuple(resblock_kernels),
        resblock_dilations=dilations,
        max_phonemes=max_phonemes, max_frames=max_frames,
        sample_rate=sample_rate)

    params = {
        "emb": _on(emb, device),
        "enc": enc,
        "proj_w": A("enc_p.proj.weight"),
        "proj_b": A("enc_p.proj.bias"),
        "flow": flow,
        "dec": {"pre_w": W("dec.conv_pre"), "pre_b": A("dec.conv_pre.bias"),
                "up_w": up_w, "up_b": up_b, "res": res,
                "post_w": W("dec.conv_post"),
                "post_b": (A("dec.conv_post.bias")
                           if "dec.conv_post.bias" in state
                           else torch.zeros((1,), device=device))},
    }
    if sdp is not None:
        params["sdp"] = sdp
    return params, cfg


# ---------------------------------------------------------------------------
# Vision converters: torch-layout state dicts -> the vision models' trees
# ---------------------------------------------------------------------------
# The models keep torch's OIHW convolutions, so a Conv2d weight needs no
# transpose; a BatchNorm folds into the conv before it (in numpy f32, as
# the reference folds). Linears become (in, out).

# ultralytics yolov8 module indices (yolov8.yaml): params live at
# "model.<idx>.<...>"; 10/13 are Upsample and 11/14/17/20 Concat (no
# params), 22 is the Detect head.
_YOLO_IDX = {
    "stem": 0, "down1": 1, "c2f1": 2, "down2": 3, "c2f2": 4,
    "down3": 5, "c2f3": 6, "down4": 7, "c2f4": 8, "sppf": 9,
    "up_c2f1": 12, "up_c2f2": 15, "pan_down1": 16, "pan_c2f1": 18,
    "pan_down2": 19, "pan_c2f2": 21,
}
# YOLOv5(u) module indices (yolov5.yaml; Detect at 24).
_YOLO_V5_IDX = {
    "stem": 0, "down1": 1, "c3_1": 2, "down2": 3, "c3_2": 4,
    "down3": 5, "c3_3": 6, "down4": 7, "c3_4": 8, "sppf": 9,
    "pre_up1": 10, "up_c3_1": 13, "pre_up2": 14, "up_c3_2": 17,
    "pan_down1": 18, "pan_c3_1": 20, "pan_down2": 21, "pan_c3_2": 23,
}
_YOLO_BN_EPS = 1e-3  # ultralytics Conv: BatchNorm2d(c2, eps=0.001)
_TF_BN_EPS = 1e-3    # timm tf_* models: BatchNorm eps 0.001


def _fold_bn_into(state: Dict[str, Any], conv_key: str, bn_prefix: str,
                  eps: float, device: torch.device) -> Dict[str, Any]:
    """Conv2d(bias=False) + BatchNorm2d -> one OIHW conv + bias:
    w' = w * gamma / sqrt(var + eps) per out channel, b' = beta - mean *
    gamma / sqrt(var + eps)."""
    w = _f32(state[conv_key])
    gamma = _f32(state[f"{bn_prefix}.weight"])
    beta = _f32(state[f"{bn_prefix}.bias"])
    mean = _f32(state[f"{bn_prefix}.running_mean"])
    var = _f32(state[f"{bn_prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"w": _on(w * scale[:, None, None, None], device),
            "b": _on(beta - mean * scale, device)}


def _fold_conv_bn(state: Dict[str, Any], prefix: str,
                  device: torch.device) -> Dict[str, Any]:
    """ultralytics Conv (conv + bn) -> OIHW conv + bias."""
    return _fold_bn_into(state, f"{prefix}.conv.weight", f"{prefix}.bn",
                         _YOLO_BN_EPS, device)


def _plain_conv(state: Dict[str, Any], prefix: str, device: torch.device,
                bias: bool = True) -> Dict[str, Any]:
    """torch Conv2d (no BN) -> OIHW conv (+ bias, else None)."""
    return {"w": _on(state[f"{prefix}.weight"], device),
            "b": _on(state[f"{prefix}.bias"], device) if bias else None}


def _bottlenecks(state, prefix: str, device) -> list:
    m = []
    j = 0
    while f"{prefix}.m.{j}.cv1.conv.weight" in state:
        m.append({"cv1": _fold_conv_bn(state, f"{prefix}.m.{j}.cv1", device),
                  "cv2": _fold_conv_bn(state, f"{prefix}.m.{j}.cv2", device)})
        j += 1
    return m


def _c2f_from_torch(state, prefix: str, device) -> Dict[str, Any]:
    return {"cv1": _fold_conv_bn(state, f"{prefix}.cv1", device),
            "m": _bottlenecks(state, prefix, device),
            "cv2": _fold_conv_bn(state, f"{prefix}.cv2", device)}


def _c3_from_torch(state, prefix: str, device) -> Dict[str, Any]:
    """v5 C3: cv1/cv2 laterals, the bottleneck chain, the cv3 merge."""
    return {"cv1": _fold_conv_bn(state, f"{prefix}.cv1", device),
            "cv2": _fold_conv_bn(state, f"{prefix}.cv2", device),
            "m": _bottlenecks(state, prefix, device),
            "cv3": _fold_conv_bn(state, f"{prefix}.cv3", device)}


def detector_config_from_torch(state: Dict[str, Any],
                               prefix: str = "model."):
    """DetectorConfig from an ultralytics-layout state dict. The variant
    comes from the Detect module's index: v8 puts it at model.22, v5(u) at
    model.24."""
    from trackiellm_tpu_torch.models.detector import DetectorConfig

    def cout(name):
        return int(np.shape(state[f"{prefix}{name}.conv.weight"])[0])

    v5 = f"{prefix}24.cv2.0.2.weight" in state
    det = f"{prefix}24" if v5 else f"{prefix}22"
    channels = (cout("0"), cout("1"), cout("3"), cout("5"), cout("7"))
    depths = []
    for idx in (2, 4, 6, 8):
        j = 0
        while f"{prefix}{idx}.m.{j}.cv1.conv.weight" in state:
            j += 1
        depths.append(j)
    n_box = int(np.shape(state[f"{det}.cv2.0.2.weight"])[0])
    nc = int(np.shape(state[f"{det}.cv3.0.2.weight"])[0])
    return DetectorConfig(num_classes=nc, channels=channels,
                          depths=tuple(depths), reg_max=n_box // 4,
                          variant="v5" if v5 else "v8")


def detector_from_torch(state: Dict[str, Any], prefix: str = "model.",
                        device: Optional[torch.device] = None):
    """ultralytics YOLOv8 or YOLOv5u state dict (names "model.<idx>...")
    -> (params, DetectorConfig) for models/detector, on ``device`` (the
    CUDA card by default). The variant is detected; BN folds into each
    conv. The Detect head's fixed DFL conv is not copied: detector_forward
    computes the softmax expectation itself."""
    device = default_device(device, "convert")
    cfg = detector_config_from_torch(state, prefix)
    idx_table = _YOLO_V5_IDX if cfg.variant == "v5" else _YOLO_IDX
    params: Dict[str, Any] = {}
    for name, idx in idx_table.items():
        pfx = f"{prefix}{idx}"
        if name == "sppf":
            params[name] = {"cv1": _fold_conv_bn(state, f"{pfx}.cv1", device),
                            "cv2": _fold_conv_bn(state, f"{pfx}.cv2", device)}
        elif "c2f" in name:
            params[name] = _c2f_from_torch(state, pfx, device)
        elif "c3" in name:
            params[name] = _c3_from_torch(state, pfx, device)
        else:
            params[name] = _fold_conv_bn(state, pfx, device)
    det = f"{prefix}{24 if cfg.variant == 'v5' else 22}"
    for i in range(3):
        for part, branch in (("box", "cv2"), ("cls", "cv3")):
            for k in (1, 2):
                params[f"head{i}_{part}{k}"] = _fold_conv_bn(
                    state, f"{det}.{branch}.{i}.{k - 1}", device)
            params[f"head{i}_{part}3"] = _plain_conv(
                state, f"{det}.{branch}.{i}.2", device)
    return params, cfg


# MiDaS _make_efficientnet_backbone slices the effnet into 4 sequential
# layers; (layer, position) of each MBConv stage in the state dict:
#   layer1 = [conv_stem, bn1, act, blocks0, blocks1]
#   layer2 = [blocks2]   layer3 = [blocks3, blocks4]
#   layer4 = [blocks5, blocks6]
_MIDAS_STAGE_POS = ((1, 3), (1, 4), (2, 0), (3, 0), (3, 1), (4, 0), (4, 1))
_LITE_STRIDES = (1, 2, 2, 2, 1, 2, 1)


def midas_config_from_torch(state: Dict[str, Any], prefix: str = ""):
    """DepthConfig from a MidasNet_small state dict."""
    from trackiellm_tpu_torch.models.depth import DepthConfig, MBStage

    stem_ch = int(np.shape(state[f"{prefix}pretrained.layer1.0.weight"])[0])
    stages = []
    cin = stem_ch
    for (layer, pos), stride in zip(_MIDAS_STAGE_POS, _LITE_STRIDES):
        base = f"{prefix}pretrained.layer{layer}.{pos}"
        k = int(np.shape(state[f"{base}.0.conv_dw.weight"])[2])
        if f"{base}.0.conv_pwl.weight" not in state:  # DepthwiseSeparable
            cout = int(np.shape(state[f"{base}.0.conv_pw.weight"])[0])
            expand = 1
        else:
            cout = int(np.shape(state[f"{base}.0.conv_pwl.weight"])[0])
            mid = int(np.shape(state[f"{base}.0.conv_pw.weight"])[0])
            expand = mid // cin
        n = 0
        while f"{base}.{n}.conv_dw.weight" in state:
            n += 1
        stages.append(MBStage(k, stride, expand, cout, n))
        cin = cout
    features = int(np.shape(state[f"{prefix}scratch.layer1_rn.weight"])[0])
    return DepthConfig(stem_ch=stem_ch, stages=tuple(stages),
                       features=features)


def midas_small_from_torch(state: Dict[str, Any], prefix: str = "",
                           device: Optional[torch.device] = None):
    """MiDaS v2.1 small checkpoint ("pretrained.layer*" efficientnet-lite3
    + "scratch.*" RefineNet; the bundled ``midas_small`` name map) ->
    (params, DepthConfig) for models/depth, on ``device`` (the CUDA card by
    default). The encoder's BN folds into each conv."""
    device = default_device(device, "convert")
    cfg = midas_config_from_torch(state, prefix)

    def fold(base, conv, bn):
        return _fold_bn_into(state, f"{base}.{conv}.weight", f"{base}.{bn}",
                             _TF_BN_EPS, device)

    blocks = []
    for (layer, pos), st in zip(_MIDAS_STAGE_POS, cfg.stages):
        stage = []
        for j in range(st.repeats):
            base = f"{prefix}pretrained.layer{layer}.{pos}.{j}"
            if st.expand == 1:
                stage.append({"dw": fold(base, "conv_dw", "bn1"),
                              "pw": fold(base, "conv_pw", "bn2")})
            else:
                stage.append({"pw": fold(base, "conv_pw", "bn1"),
                              "dw": fold(base, "conv_dw", "bn2"),
                              "pwl": fold(base, "conv_pwl", "bn3")})
        blocks.append(stage)

    sc = f"{prefix}scratch"

    def rcu(rn, unit):
        base = f"{sc}.refinenet{rn}.resConfUnit{unit}"
        return {"c1": _plain_conv(state, f"{base}.conv1", device),
                "c2": _plain_conv(state, f"{base}.conv2", device)}

    refine = [{"rcu1": rcu(k + 1, 1), "rcu2": rcu(k + 1, 2),
               "out": _plain_conv(state, f"{sc}.refinenet{k + 1}.out_conv",
                                  device)}
              for k in range(4)]
    params = {
        "stem": _fold_bn_into(state, f"{prefix}pretrained.layer1.0.weight",
                              f"{prefix}pretrained.layer1.1", _TF_BN_EPS,
                              device),
        "blocks": blocks,
        "layer_rn": [_plain_conv(state, f"{sc}.layer{k + 1}_rn", device,
                                 bias=False) for k in range(4)],
        "refine": refine,
        "head1": _plain_conv(state, f"{sc}.output_conv.0", device),
        "head2": _plain_conv(state, f"{sc}.output_conv.2", device),
        "head3": _plain_conv(state, f"{sc}.output_conv.4", device),
    }
    return params, cfg


def ocr_from_torch(state: Dict[str, Any],
                   device: Optional[torch.device] = None):
    """CRNN checkpoint (three Conv2d blocks, the bidirectional GRU as two
    GRUCell-layout sides "gru_fwd"/"gru_bwd", a Linear CTC head) ->
    (params, OCRConfig) for models/ocr, on ``device`` (the CUDA card by
    default).

    models/ocr keeps one fused bias on the input side, torch two: bias_hh
    folds into it for the r and z gates, but the n gate's hidden bias
    (scaled by r) cannot fold exactly, so it must be zero."""
    from trackiellm_tpu_torch.models.ocr import OCRConfig

    device = default_device(device, "convert")
    conv_ch = int(np.shape(state["conv3.weight"])[0])
    hidden = int(np.shape(state["gru_fwd.weight_hh"])[1])
    num_classes = int(np.shape(state["out.weight"])[0])

    def gru(side):
        wi = _f32(state[f"{side}.weight_ih"])
        wh = _f32(state[f"{side}.weight_hh"])
        bi = _f32(state[f"{side}.bias_ih"]).copy()
        bh = _f32(state[f"{side}.bias_hh"])
        h = wh.shape[1]
        if np.any(bh[2 * h:] != 0):
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                "CRNN GRU bias_hh[n] must be zero to fold into the "
                "fused-bias layout")
        bi[:2 * h] += bh[:2 * h]
        return {"wi": _on(wi.T, device), "wh": _on(wh.T, device),
                "b": _on(bi, device)}

    params = {
        "conv1": _plain_conv(state, "conv1", device),
        "conv2": _plain_conv(state, "conv2", device),
        "conv3": _plain_conv(state, "conv3", device),
        "gru_fwd": gru("gru_fwd"),
        "gru_bwd": gru("gru_bwd"),
        "out_w": _on(_f32(state["out.weight"]).T, device),
        "out_b": _on(state["out.bias"], device),
    }
    cfg = OCRConfig(conv_ch=conv_ch, hidden=hidden, num_classes=num_classes)
    return params, cfg


def dpt_swinv2_config_from_torch(state: Dict[str, Any],
                                 image_size: int = 256,
                                 window_size: int = 16):
    """DPTSwinConfig from an HF DPTForDepthEstimation (swinv2 backbone)
    state dict. ``window_size`` is not in the weights (the CPB MLP is
    size-independent and the coords table a non-persistent buffer): pass
    the checkpoint config's (tiny_256: 16; base/large_384: 24)."""
    from trackiellm_tpu_torch.models.dpt import DPTSwinConfig

    proj = np.shape(
        state["backbone.embeddings.patch_embeddings.projection.weight"])
    depths, heads = [], []
    i = 0
    blk = "backbone.encoder.layers.{}.blocks.{}.attention.self.logit_scale"
    while blk.format(i, 0) in state:
        j = 0
        while blk.format(i, j) in state:
            j += 1
        depths.append(j)
        heads.append(int(np.shape(state[blk.format(i, 0)])[0]))
        i += 1
    mid0 = int(np.shape(state["backbone.encoder.layers.0.blocks.0."
                              "intermediate.dense.weight"])[0])
    return DPTSwinConfig(
        image_size=image_size, patch_size=int(proj[2]),
        embed_dim=int(proj[0]), depths=tuple(depths),
        num_heads=tuple(heads), window_size=window_size,
        mlp_ratio=mid0 / int(proj[0]),
        fusion_hidden=int(np.shape(state["neck.convs.0.weight"])[0]))


def dpt_swinv2_from_torch(state: Dict[str, Any], image_size: int = 256,
                          window_size: int = 16,
                          device: Optional[torch.device] = None):
    """HF ``DPTForDepthEstimation`` (Swinv2 backbone: the class that loads
    Intel/dpt-swinv2-tiny-256) state dict -> (params, DPTSwinConfig) for
    models/dpt, on ``device`` (the CUDA card by default).

    Names: backbone.embeddings.* -> patch_embed / embed_norm;
    backbone.encoder.layers.{i}.blocks.{j}.* -> stages[i].blocks[j];
    .downsample.* -> stages[i].merge; neck.convs.{i} -> neck_convs;
    neck.fusion_stage.layers.{i} -> fusion[i] (layer 0's unused
    residual_layer1 is skipped); head.head.{0,2,4} -> head1..3."""
    device = default_device(device, "convert")
    cfg = dpt_swinv2_config_from_torch(state, image_size, window_size)

    def ln(prefix):
        return {"g": _on(state[f"{prefix}.weight"], device),
                "b": _on(state[f"{prefix}.bias"], device)}

    def mat(key):
        return _on(_f32(state[key]).T, device)

    stages = []
    for i in range(len(cfg.depths)):
        blocks = []
        for j in range(cfg.depths[i]):
            pre = f"backbone.encoder.layers.{i}.blocks.{j}"
            att = f"{pre}.attention.self"
            q = _lin(state, f"{att}.query", device)
            v = _lin(state, f"{att}.value", device)
            o = _lin(state, f"{pre}.attention.output.dense", device)
            wi = _lin(state, f"{pre}.intermediate.dense", device)
            wp = _lin(state, f"{pre}.output.dense", device)
            cpb0 = _lin(state, f"{att}.continuous_position_bias_mlp.0",
                        device)
            blocks.append({
                "wq": q["w"], "bq": q["b"], "wk": mat(f"{att}.key.weight"),
                "wv": v["w"], "bv": v["b"], "wo": o["w"], "bo": o["b"],
                "wi": wi["w"], "bi": wi["b"], "wp": wp["w"], "bp": wp["b"],
                "ln1": ln(f"{pre}.layernorm_before"),
                "ln2": ln(f"{pre}.layernorm_after"),
                "logit_scale": _on(state[f"{att}.logit_scale"], device),
                "cpb": {"w0": cpb0["w"], "b0": cpb0["b"],
                        "w1": mat(f"{att}.continuous_position_bias_mlp."
                                  "2.weight")},
            })
        stage: Dict[str, Any] = {"blocks": blocks}
        down = f"backbone.encoder.layers.{i}.downsample"
        if f"{down}.reduction.weight" in state:
            stage["merge"] = {"w": mat(f"{down}.reduction.weight"),
                              "norm": ln(f"{down}.norm")}
        stages.append(stage)

    def rcu(prefix):
        return {"c1": _plain_conv(state, f"{prefix}.convolution1", device),
                "c2": _plain_conv(state, f"{prefix}.convolution2", device)}

    fusion = []
    for i in range(len(cfg.depths)):
        pre = f"neck.fusion_stage.layers.{i}"
        p = {"rcu2": rcu(f"{pre}.residual_layer2"),
             "out": _plain_conv(state, f"{pre}.projection", device)}
        if i > 0:  # layer 0 never receives a residual
            p["rcu1"] = rcu(f"{pre}.residual_layer1")
        fusion.append(p)

    params = {
        "patch_embed": _plain_conv(
            state, "backbone.embeddings.patch_embeddings.projection", device),
        "embed_norm": ln("backbone.embeddings.norm"),
        "stages": stages,
        "neck_convs": [_plain_conv(state, f"neck.convs.{i}", device,
                                   bias=False)
                       for i in range(len(cfg.depths))],
        "fusion": fusion,
        "head1": _plain_conv(state, "head.head.0", device),
        "head2": _plain_conv(state, "head.head.2", device),
        "head3": _plain_conv(state, "head.head.4", device),
    }
    return params, cfg
