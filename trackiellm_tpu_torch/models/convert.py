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
card and on the CPU. DeepSeek-V2/V3 (``deepseek2``, MLA), Mamba, Falcon,
Llama-4, GLM-4-MoE and Qwen3-Next have converters of their own
(``gguf_convert_auto`` dispatches them). Every transformers state dict
the JAX package converts has its ``*_from_hf`` here too (the LLM
families' at the end of this module, DeepSeek's, Mamba's and
Qwen3-Next's beside their GGUF routes), each giving the JAX converter's
bytes.

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

The multimodal routes (``llava_from_hf``, ``paligemma_from_hf`` with its
text half ``gemma_from_hf``, LLaVA's Llama text half ``smollm3_from_hf``,
and ``gguf_to_clip_params`` for a llama.cpp "mmproj" file) read
transformers state dicts (``load_state_dict``) or GGUF tensors as host
numpy and give the LLM tree (requantized on ``device`` when ``bits`` asks)
and the CLIP/SigLIP tree of ``models/clip.py`` in f32.

The perception models' converters give their trees in f32 on ``device``:
``bert_from_hf`` and ``gguf_to_bert_params`` (with its WordPiece
tokenizer) for ``models/embedder.py``, ``trocr_from_hf`` for
``models/trocr.py``, ``ast_from_hf`` (with the checkpoint's labels) for
``models/ast.py`` and ``sound_classifier_from_torch`` (OIHW) for
``models/sound_classifier.py``.
"""

from __future__ import annotations

import math
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

def _math_key(md: Dict[str, Any], name: str, default,
              heuristic: str = ""):
    """Read a GGUF metadata key whose value changes the math (gating
    function, QK-norm presence, weight-norm flags): an absent key defaults
    by heuristic with a loud warning, and ``TRACKIE_GGUF_STRICT=1`` turns
    the guess into a hard failure (the llama4 and glm4moe routes read
    such keys)."""
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


def _transposed(a: np.ndarray) -> np.ndarray:
    """``a.T`` as a contiguous host copy, the same values: torch's blocked
    copy moves a (32,000 x 4,096) f32 matrix about 7x faster than numpy's
    strided one (a 32,000-piece vocabulary's head and embedding dominate a
    1-layer conversion's host time)."""
    if a.ndim != 2 or not a.flags.writeable:
        return np.ascontiguousarray(a.T)
    return torch.from_numpy(a).t().contiguous().numpy()


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
    ``gguf_to_llm_params`` on the same file."""
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
        return _transposed(load_gguf_tensor(gguf, name))

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


def _converter_tools(device: torch.device, bits: Optional[int], group: int,
                     dtype: torch.dtype):
    """(tensor, maybe_quant, stack) of the arch routes below:
    ``tensor(a, dt)`` puts f32 numpy on the device in ``dt`` (bf16 rounds
    to nearest even, as ``jnp.asarray(a, bf16)``); ``maybe_quant(w)``
    requantizes a (K, N) matrix on the device at ``bits`` (4, 8) or keeps
    it in ``dtype``; ``stack(items)`` stacks tensors or QuantizedLinears."""
    quantize = (quantize_q4 if bits == 4
                else quantize_q8 if bits == 8 else None)

    def tensor(a, dt: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dt)

    def maybe_quant(w: np.ndarray):
        if quantize is None:
            return tensor(w, dtype)
        return quantize(tensor(w, torch.float32), group)

    def stack(items):
        if items and isinstance(items[0], QuantizedLinear):
            return QuantizedLinear(
                values=torch.stack([q.values for q in items]),
                scales=torch.stack([q.scales for q in items]))
        return torch.stack(items)
    return tensor, maybe_quant, stack


def gguf_to_llama4_params(path: str, bits: Optional[int] = 4,
                          group: int = 256,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``llama4`` GGUF (Scout/Maverick text tower) -> (params on
    ``device``, cfg), the port of
    ``trackiellm_tpu/models/convert.py:gguf_to_llama4_params`` with its
    tree and bytes: ``blk.N.ffn_{gate,up,down}_exps`` expert banks (kept
    in ``dtype``), ``*_shexp`` shared expert, ``ffn_gate_inp`` router, the
    plain ``ffn_*`` names on the dense layers of Maverick's interleave
    (``llama4.interleave_moe_layer_step``), which fill ``w_gu_mlp`` /
    ``w_down_mlp`` (zeros on MoE layers, as the experts are on dense
    ones). q/k fold from llama.cpp's interleaved rope to split-half unless
    ``TRACKIE_LLAMA4_GGUF_ROPE=none``. ``device`` defaults to the card."""
    device = default_device(device, "convert")
    gguf = read_gguf_header(path)
    md = gguf.metadata

    def key(suffix: str, default=None):
        v = md.get(f"llama4.{suffix}", default)
        if v is None:
            raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                               f"missing GGUF key llama4.{suffix}")
        return v

    dim = int(key("embedding_length"))
    n_layers = int(key("block_count"))
    n_heads = int(key("attention.head_count"))
    n_kv = int(key("attention.head_count_kv", n_heads))
    hd = int(md.get("llama4.attention.key_length", dim // n_heads))
    n_experts = int(key("expert_count"))
    hidden = int(md.get("llama4.expert_feed_forward_length",
                        key("feed_forward_length")))
    step = int(md.get("llama4.interleave_moe_layer_step", 1))
    moe_pattern = 0 if step <= 1 else step
    is_moe = [f"blk.{i}.ffn_gate_exps.weight" in gguf.tensors
              for i in range(n_layers)]
    want = ([True] * n_layers if moe_pattern == 0
            else [(i % step) == (step - 1) for i in range(n_layers)])
    if is_moe != want:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: MoE layer layout {is_moe} disagrees with "
            f"interleave_moe_layer_step={step}")
    if not any(is_moe):
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: no MoE layers (interleave_moe_layer_step={step} "
            f"exceeds block_count={n_layers}?)")
    first_moe = is_moe.index(True)
    shared_rows = load_gguf_tensor(
        gguf, f"blk.{first_moe}.ffn_gate_shexp.weight").shape[0]
    hidden_mlp = 0
    if moe_pattern:
        hidden_mlp = load_gguf_tensor(gguf, "blk.0.ffn_gate.weight").shape[0]
    vocab = int(md.get("llama4.vocab_size",
                       gguf.tensors["token_embd.weight"].shape[0]))
    qk_l2norm = bool(_math_key(
        md, "llama4.attention.use_kq_norm", moe_pattern == 0,
        "interleave signature: Scout(uniform MoE)=True"))
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd, hidden_dim=hidden,
        norm_eps=float(md.get(
            "llama4.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(key("rope.freq_base", 500000.0)),
        max_seq=int(key("context_length", 8192)),
        sliding_window=int(key("context_length", 8192)),
        n_experts=n_experts,
        n_experts_used=int(md.get("llama4.expert_used_count", 1)),
        moe_score_func="sigmoid_topk", moe_norm_topk=False,
        moe_scale_input=True, moe_shared_hidden=shared_rows,
        moe_shared_gated=False,
        nope_pattern=int(md.get("llama4.no_rope_layer_interval", 4)),
        qk_l2norm=qk_l2norm, attn_temp_tuning=True,
        attn_temp_floor=float(md.get(
            "llama4.attention.temperature_length", 8192.0)),
        attn_temp_scale=0.1,
        attn_chunk=int(md.get("llama4.attention.chunk_size", 8192)),
        moe_pattern=moe_pattern)
    tensor, maybe_quant, stack = _converter_tools(device, bits, group, dtype)

    def mat(name: str) -> np.ndarray:
        return np.ascontiguousarray(load_gguf_tensor(gguf, name).T)

    def vec(name: str) -> torch.Tensor:
        return tensor(load_gguf_tensor(gguf, name), dtype)

    def zeros(*shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    fold = os.environ.get("TRACKIE_LLAMA4_GGUF_ROPE", "fold") != "none"

    def deint(w, heads):
        return _deinterleave_rope_cols(w, heads, hd, hd) if fold else w

    ls: Dict[str, list] = {
        "attn_norm": [], "wqkv": [], "wo": [], "mlp_norm": [],
        "w_gu": [], "w_down": [], "moe_gate": [],
        "shared_gu": [], "shared_down": []}
    if moe_pattern:
        ls["w_gu_mlp"], ls["w_down_mlp"] = [], []
    for i in range(n_layers):
        p = f"blk.{i}"
        ls["attn_norm"].append(vec(f"{p}.attn_norm.weight"))
        ls["mlp_norm"].append(vec(f"{p}.ffn_norm.weight"))
        qkv = np.concatenate(
            [deint(mat(f"{p}.attn_q.weight"), n_heads),
             deint(mat(f"{p}.attn_k.weight"), n_kv),
             mat(f"{p}.attn_v.weight")], axis=1)
        ls["wqkv"].append(maybe_quant(qkv))
        ls["wo"].append(maybe_quant(mat(f"{p}.attn_output.weight")))
        if is_moe[i]:
            g = load_gguf_tensor(gguf, f"{p}.ffn_gate_exps.weight")
            u = load_gguf_tensor(gguf, f"{p}.ffn_up_exps.weight")
            dn = load_gguf_tensor(gguf, f"{p}.ffn_down_exps.weight")
            if g.shape != (n_experts, hidden, dim):
                raise TrackieError(
                    ErrorCode.MODEL_METADATA_INVALID,
                    f"{p}.ffn_gate_exps.weight shape {g.shape} != "
                    f"(E={n_experts}, H={hidden}, D={dim})")
            gu = np.concatenate([g.transpose(0, 2, 1),
                                 u.transpose(0, 2, 1)], axis=2)
            ls["w_gu"].append(tensor(gu, dtype))
            ls["w_down"].append(tensor(dn.transpose(0, 2, 1), dtype))
            ls["moe_gate"].append(tensor(
                load_gguf_tensor(gguf, f"{p}.ffn_gate_inp.weight").T, dtype))
            ls["shared_gu"].append(tensor(np.concatenate(
                [mat(f"{p}.ffn_gate_shexp.weight"),
                 mat(f"{p}.ffn_up_shexp.weight")], axis=1), dtype))
            ls["shared_down"].append(tensor(
                mat(f"{p}.ffn_down_shexp.weight"), dtype))
            if moe_pattern:
                ls["w_gu_mlp"].append(zeros(dim, 2 * hidden_mlp))
                ls["w_down_mlp"].append(zeros(hidden_mlp, dim))
        else:
            ls["w_gu"].append(zeros(n_experts, dim, 2 * hidden))
            ls["w_down"].append(zeros(n_experts, hidden, dim))
            ls["moe_gate"].append(zeros(dim, n_experts))
            ls["shared_gu"].append(zeros(dim, 2 * shared_rows))
            ls["shared_down"].append(zeros(shared_rows, dim))
            ls["w_gu_mlp"].append(tensor(np.concatenate(
                [mat(f"{p}.ffn_gate.weight"), mat(f"{p}.ffn_up.weight")],
                axis=1), dtype))
            ls["w_down_mlp"].append(tensor(mat(f"{p}.ffn_down.weight"),
                                           dtype))
        log.info("converted llama4 layer %d/%d", i + 1, n_layers)

    tok_emb = load_gguf_tensor(gguf, "token_embd.weight")
    lm_head = (mat("output.weight") if "output.weight" in gguf.tensors
               else np.ascontiguousarray(tok_emb.T))
    params = {
        "tok_emb": tensor(tok_emb, dtype),
        "layers": {k: stack(v) for k, v in ls.items()},
        "out_norm": vec("output_norm.weight"),
        "lm_head": maybe_quant(lm_head),
    }
    if "rope_freqs.weight" in gguf.tensors:
        params["rope_factors"] = tensor(
            load_gguf_tensor(gguf, "rope_freqs.weight"), torch.float32)
    return params, cfg


def gguf_to_falcon_params(path: str, *, bits: Optional[int] = None,
                          group: int = 256, max_seq: Optional[int] = None,
                          dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``falcon`` GGUF -> (params on ``device``, cfg), the port
    of ``trackiellm_tpu/models/convert.py:gguf_to_falcon_params`` with its
    tree and bytes: ``attn_qkv`` rows are already q|k|v (llama.cpp
    un-groups Falcon's fused projection), LayerNorms with biases, an
    ungated exact-GELU MLP on the parallel residual, and ``attn_norm_2``
    (the 40B/180B second norm) as ``mlp_norm`` with ``parallel_mlp_norm``.
    The matrices are cast to ``dtype`` first, then ``quantize_params``
    requantizes them at ``bits``, as the reference does."""
    device = default_device(device, "convert")
    gguf = read_gguf_header(path)
    arch = gguf.architecture or ""
    if arch != "falcon":
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: architecture {arch!r}, want 'falcon'")
    md = gguf.metadata

    def t(name: str) -> np.ndarray:
        return load_gguf_tensor(gguf, name)

    if "falcon.attention.head_count" not in md:
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: missing falcon.attention.head_count")
    emb = t("token_embd.weight")
    vocab, dim = emb.shape
    n_heads = int(md["falcon.attention.head_count"])
    n_kv = int(md.get("falcon.attention.head_count_kv", 1))
    hd = dim // n_heads
    n_layers = int(md.get(
        "falcon.block_count",
        len({k.split(".")[1] for k in gguf.tensors if k.startswith("blk.")})))
    qkv_rows = gguf.tensors["blk.0.attn_qkv.weight"].shape[0]
    if qkv_rows != (n_heads + 2 * n_kv) * hd:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: attn_qkv rows {qkv_rows} != (H+2G)*hd = "
            f"{(n_heads + 2 * n_kv) * hd} (H={n_heads}, G={n_kv})")
    two_norm = "blk.0.attn_norm_2.weight" in gguf.tensors
    qkv_bias = "blk.0.attn_qkv.bias" in gguf.tensors
    out_bias = "blk.0.attn_output.bias" in gguf.tensors
    mlp_bias = "blk.0.ffn_up.bias" in gguf.tensors
    ctx = int(md.get("falcon.context_length", 2048))
    eff_seq = max_seq if max_seq is not None else min(ctx, 4096)
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        hidden_dim=gguf.tensors["blk.0.ffn_up.weight"].shape[0],
        norm_eps=float(md.get("falcon.attention.layer_norm_epsilon", 1e-5)),
        rope_theta=float(md.get("falcon.rope.freq_base", 1e4)),
        max_seq=eff_seq, sliding_window=eff_seq, norm_type="layernorm",
        parallel_residual=True, parallel_mlp_norm=two_norm,
        mlp_gated=False, act="gelu_exact",
        qkv_bias=qkv_bias, out_bias=out_bias, mlp_bias=mlp_bias)
    tensor, _, _ = _converter_tools(device, None, group, dtype)

    ls: Dict[str, list] = {"attn_norm": [], "wqkv": [], "wo": [],
                           "w_gu": [], "w_down": []}
    opt: Dict[str, list] = {"mlp_norm": [], "wqkv_bias": [], "wo_bias": [],
                            "w_gu_b": [], "w_down_b": []}
    for i in range(n_layers):
        b = f"blk.{i}."
        ls["attn_norm"].append({"g": t(b + "attn_norm.weight"),
                                "b": t(b + "attn_norm.bias")})
        if two_norm:
            opt["mlp_norm"].append({"g": t(b + "attn_norm_2.weight"),
                                    "b": t(b + "attn_norm_2.bias")})
        ls["wqkv"].append(t(b + "attn_qkv.weight").T)
        ls["wo"].append(t(b + "attn_output.weight").T)
        ls["w_gu"].append(t(b + "ffn_up.weight").T)
        ls["w_down"].append(t(b + "ffn_down.weight").T)
        if qkv_bias:
            opt["wqkv_bias"].append(t(b + "attn_qkv.bias"))
        if out_bias:
            opt["wo_bias"].append(t(b + "attn_output.bias"))
        if mlp_bias:
            opt["w_gu_b"].append(t(b + "ffn_up.bias"))
            opt["w_down_b"].append(t(b + "ffn_down.bias"))

    def stacked(vals):
        if vals and isinstance(vals[0], dict):
            return {kk: tensor(np.stack([v[kk] for v in vals]), dtype)
                    for kk in vals[0]}
        return tensor(np.stack(vals), dtype)

    layers = {k: stacked(v) for k, v in ls.items()}
    layers.update({k: stacked(v) for k, v in opt.items() if v})
    params = {
        "tok_emb": tensor(emb, dtype),
        "layers": layers,
        "out_norm": {"g": tensor(t("output_norm.weight"), dtype),
                     "b": tensor(t("output_norm.bias"), dtype)},
        "lm_head": tensor(t("output.weight").T
                          if "output.weight" in gguf.tensors
                          else np.ascontiguousarray(emb.T), dtype),
    }
    if bits:
        params = llm_model.quantize_params(params, bits=bits, group=group)
    return params, cfg


def gguf_to_glm4moe_params(path: str, bits: Optional[int] = 4,
                           group: int = 256,
                           dtype: torch.dtype = torch.bfloat16,
                           device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``glm4moe`` GGUF (GLM-4.5/4.5-Air/4.6) -> (params on
    ``device``, cfg), the port of
    ``trackiellm_tpu/models/convert.py:gguf_to_glm4moe_params`` with its
    tree and bytes: ``leading_dense_block_count`` dense layers first (in
    ``w_gu_mlp``/``w_down_mlp``), sigmoid routing by default
    (``expert_gating_func``), ``exp_probs_b.bias`` as the selection-only
    ``moe_gate_bias`` (f32), groups scored by top-2 sum, an ungated
    shared expert, split-half rope at ``rope.dimension_count``. Expert
    banks stay in ``dtype``. At ``bits`` 4 or 8 the dense layers' zero
    shared-expert slots are quantized too, so the stack is one
    QuantizedLinear; the reference's converter fails there (it stacks
    arrays among QuantizedLinears), so those bytes are held to its
    quantizers, matrix by matrix."""
    device = default_device(device, "convert")
    gguf = read_gguf_header(path)
    md = gguf.metadata
    t = gguf.tensors
    arch = "glm4moe"

    def key(suffix: str, default=None):
        v = md.get(f"{arch}.{suffix}", default)
        if v is None:
            raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                               f"missing GGUF key {arch}.{suffix}")
        return v

    dim = int(key("embedding_length"))
    n_layers = int(key("block_count"))
    n_heads = int(key("attention.head_count"))
    n_kv = int(key("attention.head_count_kv", n_heads))
    hd = int(md.get(f"{arch}.attention.key_length", dim // n_heads))
    rot = int(md.get(f"{arch}.rope.dimension_count", hd // 2))
    n_experts = int(md.get(f"{arch}.expert_count", 0))
    first_k = int(md.get(f"{arch}.leading_dense_block_count", -1))
    if first_k < 0:
        first_k = sum(1 for i in range(n_layers)
                      if f"blk.{i}.ffn_gate.weight" in t)
    if not n_experts or first_k >= n_layers:
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: no MoE layers (dense GLM-4 loads "
                           "through the glm4 arch)")
    gating = int(_math_key(md, f"{arch}.expert_gating_func", 2,
                           "GLM-4.5 publishes sigmoid routing"))
    shex = f"blk.{first_k}.ffn_gate_shexp.weight"
    shared_hidden = t[shex].shape[0] if shex in t else 0
    moe_hidden = int(md.get(
        f"{arch}.expert_feed_forward_length",
        t[f"blk.{first_k}.ffn_gate_exps.weight"].shape[1]))
    hidden_dense = t["blk.0.ffn_gate.weight"].shape[0] if first_k else 0
    qk_norm = "blk.0.attn_q_norm.weight" in t
    vocab = int(md.get("tokenizer.ggml.tokens_count",
                       md.get(f"{arch}.vocab_size",
                              t["token_embd.weight"].shape[0])))
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd, hidden_dim=moe_hidden,
        norm_eps=float(md.get(
            f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        max_seq=int(key("context_length", 8192)),
        sliding_window=int(key("context_length", 8192)),
        qkv_bias="blk.0.attn_q.bias" in t, qk_norm=qk_norm,
        partial_rotary_factor=rot / hd,
        n_experts=n_experts,
        n_experts_used=int(md.get(f"{arch}.expert_used_count", 8)),
        moe_score_func="sigmoid" if gating == 2 else "softmax",
        moe_norm_topk=bool(md.get(f"{arch}.expert_weights_norm", True)),
        moe_routed_scale=float(md.get(f"{arch}.expert_weights_scale", 1.0)
                               or 1.0),
        moe_n_groups=int(md.get(f"{arch}.expert_group_count", 1) or 1),
        moe_topk_groups=int(md.get(f"{arch}.expert_group_used_count", 1)
                            or 1),
        moe_group_score="top2sum",
        moe_shared_hidden=shared_hidden, moe_shared_gated=False,
        moe_first_dense=first_k)
    tensor, maybe_quant, stack = _converter_tools(device, bits, group, dtype)

    def mat(name: str) -> np.ndarray:
        return np.ascontiguousarray(load_gguf_tensor(gguf, name).T)

    def vec(name: str) -> torch.Tensor:
        return tensor(load_gguf_tensor(gguf, name), dtype)

    def zeros(*shape, dt=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dt or dtype, device=device)

    ls: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "mlp_norm", "w_gu", "w_down",
        "moe_gate", "moe_gate_bias", "shared_gu", "shared_down")}
    if qk_norm:
        ls["q_norm"], ls["k_norm"] = [], []
    if cfg.qkv_bias:
        ls["wqkv_bias"] = []
    if first_k:
        ls["w_gu_mlp"], ls["w_down_mlp"] = [], []
    for i in range(n_layers):
        p = f"blk.{i}"
        ls["attn_norm"].append(vec(f"{p}.attn_norm.weight"))
        ls["mlp_norm"].append(vec(f"{p}.ffn_norm.weight"))
        qkv = np.concatenate([mat(f"{p}.attn_q.weight"),
                              mat(f"{p}.attn_k.weight"),
                              mat(f"{p}.attn_v.weight")], axis=1)
        ls["wqkv"].append(maybe_quant(qkv))
        if cfg.qkv_bias:
            ls["wqkv_bias"].append(torch.cat(
                [vec(f"{p}.attn_q.bias"), vec(f"{p}.attn_k.bias"),
                 vec(f"{p}.attn_v.bias")]))
        ls["wo"].append(maybe_quant(mat(f"{p}.attn_output.weight")))
        if qk_norm:
            ls["q_norm"].append(vec(f"{p}.attn_q_norm.weight"))
            ls["k_norm"].append(vec(f"{p}.attn_k_norm.weight"))
        if i >= first_k:
            g = load_gguf_tensor(gguf, f"{p}.ffn_gate_exps.weight")
            u = load_gguf_tensor(gguf, f"{p}.ffn_up_exps.weight")
            dn = load_gguf_tensor(gguf, f"{p}.ffn_down_exps.weight")
            if g.shape != (n_experts, moe_hidden, dim):
                raise TrackieError(
                    ErrorCode.MODEL_METADATA_INVALID,
                    f"{p}.ffn_gate_exps.weight shape {g.shape} != "
                    f"(E={n_experts}, H={moe_hidden}, D={dim})")
            gu = np.concatenate([g.transpose(0, 2, 1),
                                 u.transpose(0, 2, 1)], axis=2)
            ls["w_gu"].append(tensor(gu, dtype))
            ls["w_down"].append(tensor(dn.transpose(0, 2, 1), dtype))
            ls["moe_gate"].append(tensor(
                load_gguf_tensor(gguf, f"{p}.ffn_gate_inp.weight").T, dtype))
            ls["moe_gate_bias"].append(tensor(
                load_gguf_tensor(gguf, f"{p}.exp_probs_b.bias").reshape(-1),
                torch.float32))
            ls["shared_gu"].append(maybe_quant(np.concatenate(
                [mat(f"{p}.ffn_gate_shexp.weight"),
                 mat(f"{p}.ffn_up_shexp.weight")], axis=1)))
            ls["shared_down"].append(
                maybe_quant(mat(f"{p}.ffn_down_shexp.weight")))
            if first_k:
                ls["w_gu_mlp"].append(zeros(dim, 2 * hidden_dense))
                ls["w_down_mlp"].append(zeros(hidden_dense, dim))
        else:
            ls["w_gu"].append(zeros(n_experts, dim, 2 * moe_hidden))
            ls["w_down"].append(zeros(n_experts, moe_hidden, dim))
            ls["moe_gate"].append(zeros(dim, n_experts))
            ls["moe_gate_bias"].append(zeros(n_experts, dt=torch.float32))
            # Quantized like the MoE layers' (the reference stacks raw
            # zeros among QuantizedLinears here and fails at bits 4/8).
            ls["shared_gu"].append(maybe_quant(
                np.zeros((dim, 2 * shared_hidden), np.float32)))
            ls["shared_down"].append(maybe_quant(
                np.zeros((shared_hidden, dim), np.float32)))
            ls["w_gu_mlp"].append(tensor(np.concatenate(
                [mat(f"{p}.ffn_gate.weight"), mat(f"{p}.ffn_up.weight")],
                axis=1), dtype))
            ls["w_down_mlp"].append(tensor(mat(f"{p}.ffn_down.weight"),
                                           dtype))
        log.info("converted glm4moe layer %d/%d", i + 1, n_layers)

    tok_emb = load_gguf_tensor(gguf, "token_embd.weight")
    lm_head = (mat("output.weight") if "output.weight" in t
               else np.ascontiguousarray(tok_emb.T))
    params = {
        "tok_emb": tensor(tok_emb, dtype),
        "layers": {k: stack(v) for k, v in ls.items()},
        "out_norm": vec("output_norm.weight"),
        "lm_head": maybe_quant(lm_head),
    }
    return params, cfg


# ---------------------------------------------------------------------------
# DeepSeek-V2/V3 (MLA) and Mamba / Mamba-2
# ---------------------------------------------------------------------------

def _tree_on(d: Dict[str, list], tensor, dtype: torch.dtype,
             f32_keys=()) -> Dict[str, torch.Tensor]:
    """Stack each non-empty list of host arrays into one tensor on the
    device, in ``dtype`` (f32 for ``f32_keys``)."""
    return {k: tensor(np.stack(v), torch.float32 if k in f32_keys else dtype)
            for k, v in d.items() if v}


def deepseek_v2_from_hf(
        state: Dict[str, Any], *, max_seq: int = 8192,
        norm_eps: float = 1e-6, rope_theta: float = 10000.0,
        n_experts_used: int = 6, norm_topk: bool = False,
        routed_scale: float = 1.0, n_groups: int = 1, topk_groups: int = 1,
        qk_nope_head_dim: int = 128, qk_rope_head_dim: int = 64,
        score_func: str = "softmax", group_score: str = "max",
        yarn_factor: float = 0.0, yarn_original_max_seq: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
        bits: Optional[int] = None, group: int = 64) -> tuple:
    """A transformers DeepSeek-V2 state dict -> (params, MLAConfig) for
    ``models/mla.py``, the port of the JAX package's converter with its
    tree and bytes: V2-Lite's full ``q_proj`` or V2's ``q_a_proj`` /
    ``q_b_proj`` LoRA with its norm, dense first-k layers, routed and
    shared experts, and (V3) ``e_score_correction_bias`` as the
    selection-only ``moe_gate_bias``. No weight is permuted: the module
    rotates adjacent pairs, as transformers' DeepseekV2 does. With
    ``bits`` the tree is requantized on ``device`` (``mla.quantize_params``,
    group 64)."""
    from trackiellm_tpu_torch.models import mla as mla_model

    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    emb = A("model.embed_tokens.weight")
    vocab, dim = emb.shape
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("model.layers.")})
    kv_a = A("model.layers.0.self_attn.kv_a_proj_with_mqa.weight")
    r = A("model.layers.0.self_attn.kv_a_layernorm.weight").shape[0]
    rope = kv_a.shape[0] - r
    if rope != qk_rope_head_dim:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"kv_a_proj implies qk_rope_head_dim={rope}, "
            f"got {qk_rope_head_dim}")
    q_lora = "model.layers.0.self_attn.q_a_proj.weight" in state
    q_out = A("model.layers.0.self_attn."
              + ("q_b_proj" if q_lora else "q_proj") + ".weight").shape[0]
    n_heads = q_out // (qk_nope_head_dim + qk_rope_head_dim)
    kv_b_out = A("model.layers.0.self_attn.kv_b_proj.weight").shape[0]
    v_head = kv_b_out // n_heads - qk_nope_head_dim
    dense_idx = [i for i in range(n_layers)
                 if f"model.layers.{i}.mlp.gate_proj.weight" in state]
    first_k = len(dense_idx)
    if dense_idx != list(range(first_k)):
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"non-prefix dense layers {dense_idx}")
    n_experts = len({k.split(".")[5] for k in state if ".mlp.experts." in k})
    moe_hidden = (A(f"model.layers.{first_k}.mlp.experts.0."
                    "gate_proj.weight").shape[0] if n_experts else 0)
    shared_key = f"model.layers.{first_k}.mlp.shared_experts.gate_proj.weight"
    shared_hidden = A(shared_key).shape[0] if shared_key in state else 0
    hidden = (A("model.layers.0.mlp.gate_proj.weight").shape[0]
              if first_k else moe_hidden)
    cfg = mla_model.MLAConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        hidden_dim=hidden,
        q_lora_rank=(A("model.layers.0.self_attn.q_a_proj.weight").shape[0]
                     if q_lora else 0),
        kv_lora_rank=r, qk_nope_head_dim=qk_nope_head_dim,
        qk_rope_head_dim=qk_rope_head_dim, v_head_dim=v_head,
        n_experts=n_experts, n_experts_used=n_experts_used,
        moe_hidden_dim=moe_hidden, moe_norm_topk=norm_topk,
        moe_shared_hidden=shared_hidden, moe_routed_scale=routed_scale,
        moe_n_groups=n_groups, moe_topk_groups=topk_groups,
        moe_score_func=score_func, moe_group_score=group_score,
        first_k_dense=first_k if n_experts else n_layers,
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq)

    attn: Dict[str, list] = {k: [] for k in (
        "attn_norm", "mlp_norm", "wkv_a", "kv_a_norm", "wkv_b", "wo",
        *(("wq_a", "q_a_norm", "wq_b") if q_lora else ("wq",)))}
    dense_mlp: Dict[str, list] = {"w_gu": [], "w_down": []}
    moe_mlp: Dict[str, list] = {"moe_gate": [], "w_gu": [], "w_down": []}
    if f"model.layers.{first_k}.mlp.gate.e_score_correction_bias" in state:
        moe_mlp["moe_gate_bias"] = []
    if shared_hidden:
        moe_mlp.update(shared_gu=[], shared_down=[])

    def gate_up(pre):
        return np.concatenate([A(f"{pre}.gate_proj.weight").T,
                               A(f"{pre}.up_proj.weight").T], axis=1)

    for i in range(n_layers):
        pre = f"model.layers.{i}"
        sa = f"{pre}.self_attn"
        attn["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        attn["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        attn["wkv_a"].append(A(f"{sa}.kv_a_proj_with_mqa.weight").T)
        attn["kv_a_norm"].append(A(f"{sa}.kv_a_layernorm.weight"))
        attn["wkv_b"].append(A(f"{sa}.kv_b_proj.weight").T)
        attn["wo"].append(A(f"{sa}.o_proj.weight").T)
        if q_lora:
            attn["wq_a"].append(A(f"{sa}.q_a_proj.weight").T)
            attn["q_a_norm"].append(A(f"{sa}.q_a_layernorm.weight"))
            attn["wq_b"].append(A(f"{sa}.q_b_proj.weight").T)
        else:
            attn["wq"].append(A(f"{sa}.q_proj.weight").T)
        if i < cfg.first_k_dense or not n_experts:
            dense_mlp["w_gu"].append(gate_up(f"{pre}.mlp"))
            dense_mlp["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
            continue
        moe_mlp["moe_gate"].append(A(f"{pre}.mlp.gate.weight").T)
        if "moe_gate_bias" in moe_mlp:
            moe_mlp["moe_gate_bias"].append(
                A(f"{pre}.mlp.gate.e_score_correction_bias"))
        moe_mlp["w_gu"].append(np.stack(
            [gate_up(f"{pre}.mlp.experts.{e}") for e in range(n_experts)]))
        moe_mlp["w_down"].append(np.stack(
            [A(f"{pre}.mlp.experts.{e}.down_proj.weight").T
             for e in range(n_experts)]))
        if shared_hidden:
            sp = f"{pre}.mlp.shared_experts"
            moe_mlp["shared_gu"].append(gate_up(sp))
            moe_mlp["shared_down"].append(A(f"{sp}.down_proj.weight").T)

    tensor = _converter_tools(device, None, group, dtype)[0]
    params = {
        "tok_emb": tensor(emb, dtype),
        "attn": _tree_on(attn, tensor, dtype),
        "dense_mlp": _tree_on(dense_mlp, tensor, dtype),
        "moe_mlp": _tree_on(moe_mlp, tensor, dtype),
        "out_norm": tensor(A("model.norm.weight"), dtype),
        "lm_head": tensor(A("lm_head.weight").T if "lm_head.weight" in state
                          else np.ascontiguousarray(emb.T), dtype),
    }
    if yarn_factor > 1.0:
        # mscale == mscale_all_dim in the published configs: the yarn
        # attention factor is 1.0 (mla.yarn_rope_factors).
        params["rope_factors"] = mla_model.yarn_rope_factors(
            cfg, yarn_factor, yarn_original_max_seq).to(device)
    if bits:
        params = mla_model.quantize_params(params, bits=bits, group=group)
    return params, cfg


def deepseek_v3_from_hf(state: Dict[str, Any], *, n_experts_used: int = 8,
                        routed_scale: float = 2.5, n_groups: int = 8,
                        topk_groups: int = 4, **kw) -> tuple:
    """A transformers DeepSeek-V3/R1 state dict: V2's MLA unchanged, with
    V3's routing (sigmoid scores, top-2-sum group scores, renormalized
    weights and the selection bias)."""
    kw.setdefault("norm_topk", True)
    return deepseek_v2_from_hf(
        state, n_experts_used=n_experts_used, routed_scale=routed_scale,
        n_groups=n_groups, topk_groups=topk_groups, score_func="sigmoid",
        group_score="top2sum", **kw)


def _neox_to_interleaved_cols(w: np.ndarray, start: int,
                              rope: int) -> np.ndarray:
    """Reorder ``rope`` columns of ``w`` from ``start`` from neox's
    half-split order [x0..x_{R/2-1} | y0..y_{R/2-1}] to the adjacent pairs
    [x0, y0, x1, y1, ...] that ``models/mla.py`` rotates."""
    half = rope // 2
    perm = np.empty(rope, np.int64)
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half) + half
    w = w.copy()
    w[..., start:start + rope] = w[..., start:start + rope][..., perm]
    return w


def mla_config_from_gguf(gguf: GGUFFile):
    """MLAConfig from llama.cpp ``deepseek2`` metadata, shape-derivable
    fields from the tensors' shapes (as the reference reads them)."""
    from trackiellm_tpu_torch.models import mla as mla_model

    md = gguf.metadata
    arch = "deepseek2"

    def key(suffix: str, default=None):
        v = md.get(f"{arch}.{suffix}", default)
        if v is None:
            raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                               f"missing GGUF key {arch}.{suffix}")
        return v

    t = gguf.tensors
    n_heads = int(key("attention.head_count"))
    n_layers = int(key("block_count"))
    r = t["blk.0.attn_kv_a_norm.weight"].shape[0]
    rope = t["blk.0.attn_kv_a_mqa.weight"].shape[0] - r  # (out, in) rows
    qk_head = int(md.get(f"{arch}.attention.key_length", 0))
    nope = (qk_head - rope) if qk_head else 0
    q_lora = "blk.0.attn_q_a.weight" in t
    if not nope:
        q_out = t["blk.0." + ("attn_q_b" if q_lora else "attn_q")
                  + ".weight"].shape[0]
        nope = q_out // n_heads - rope
    v_head = int(md.get(f"{arch}.attention.value_length", 0))
    if not v_head and "blk.0.attn_kv_b.weight" in t:
        v_head = t["blk.0.attn_kv_b.weight"].shape[0] // n_heads - nope
    if not v_head and "blk.0.attn_v_b.weight" in t:
        shp = t["blk.0.attn_v_b.weight"].shape
        v_head = int(np.prod(shp)) // (n_heads * r)
    n_experts = int(md.get(f"{arch}.expert_count", 0))
    first_k = int(md.get(f"{arch}.leading_dense_block_count", -1))
    if first_k < 0:  # dense layers carry a plain ffn_gate
        first_k = sum(1 for i in range(n_layers)
                      if f"blk.{i}.ffn_gate.weight" in t)
    shex = "blk.%d.ffn_gate_shexp.weight" % (first_k if n_experts else 0)
    shared_hidden = t[shex].shape[0] if shex in t else 0
    hidden = (t["blk.0.ffn_gate.weight"].shape[0]
              if "blk.0.ffn_gate.weight" in t
              else int(key("feed_forward_length")))
    # V3's routing rides metadata: expert_gating_func (1 softmax, 2
    # sigmoid), the weight norm and the group counts.
    gating = int(_math_key(md, f"{arch}.expert_gating_func", 1,
                           "V2 family default: softmax routing"))
    score = "sigmoid" if gating == 2 else "softmax"
    return mla_model.MLAConfig(
        vocab_size=int(md.get("tokenizer.ggml.tokens_count",
                              md.get(f"{arch}.vocab_size",
                                     t["token_embd.weight"].shape[0]))),
        dim=int(key("embedding_length")), n_layers=n_layers,
        n_heads=n_heads, hidden_dim=hidden,
        q_lora_rank=t["blk.0.attn_q_a.weight"].shape[0] if q_lora else 0,
        kv_lora_rank=r, qk_nope_head_dim=nope, qk_rope_head_dim=rope,
        v_head_dim=v_head, n_experts=n_experts,
        n_experts_used=int(md.get(f"{arch}.expert_used_count", 6)),
        moe_hidden_dim=int(md.get(f"{arch}.expert_feed_forward_length", 0)),
        moe_norm_topk=bool(md.get(f"{arch}.expert_weights_norm", False)),
        moe_shared_hidden=shared_hidden,
        moe_routed_scale=float(md.get(f"{arch}.expert_weights_scale", 1.0)),
        moe_n_groups=int(md.get(f"{arch}.expert_group_count", 1) or 1),
        moe_topk_groups=int(md.get(f"{arch}.expert_group_used_count", 1)
                            or 1),
        moe_score_func=score,
        moe_group_score="top2sum" if score == "sigmoid" else "max",
        first_k_dense=first_k if n_experts else n_layers,
        norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        max_seq=int(key("context_length", 4096)))


def gguf_to_mla_params(path: str, bits: Optional[int] = None,
                       group: int = 64, dtype: torch.dtype = torch.bfloat16,
                       max_layers: Optional[int] = None,
                       neox_rope: Optional[bool] = None,
                       device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``deepseek2`` GGUF -> (params on ``device``, MLAConfig),
    the port of the JAX package's route with its tree and bytes.

    ``neox_rope``: llama.cpp's converter reorders the rope columns of
    ``q``/``q_b`` and ``kv_a_mqa`` into neox half-split order; they are
    permuted back to adjacent pairs on ingest (default; False, or
    ``TRACKIE_DEEPSEEK2_GGUF_ROPE=interleaved``, for files written pair-
    ordered). ``kv_b`` comes as one ``attn_kv_b`` tensor or the split
    ``attn_k_b``/``attn_v_b`` pair, which is fused again. ``bits`` 4/8
    requantizes through ``mla.quantize_params`` (``wkv_b`` stays)."""
    from trackiellm_tpu_torch.models import mla as mla_model

    device = default_device(device, "convert")
    if neox_rope is None:
        neox_rope = os.environ.get("TRACKIE_DEEPSEEK2_GGUF_ROPE",
                                   "neox") != "interleaved"
    gguf = read_gguf_header(path)
    if (gguf.architecture or "") != "deepseek2":
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"not a deepseek2 GGUF: {gguf.architecture}")
    cfg = mla_config_from_gguf(gguf)
    if max_layers is not None:
        n = min(cfg.n_layers, max_layers)
        cfg = cfg._replace(n_layers=n,
                           first_k_dense=min(cfg.first_k_dense, n))

    def mat(name: str) -> np.ndarray:
        return np.ascontiguousarray(load_gguf_tensor(gguf, name).T)

    def vec(name: str) -> np.ndarray:
        return load_gguf_tensor(gguf, name)

    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)

    def fix_q_rope(w: np.ndarray) -> np.ndarray:
        if not neox_rope:
            return w
        for head in range(h):
            w = _neox_to_interleaved_cols(w, head * cfg.qk_head_dim + nope,
                                          rope)
        return w

    def as3(x: np.ndarray, per: int) -> np.ndarray:
        """A split kv_b half -> (h, r, per), whatever its stored
        orientation."""
        x = x.reshape(h, -1) if x.ndim == 1 else x
        if x.ndim == 2:
            if x.shape == (h * per, r):
                return x.reshape(h, per, r).transpose(0, 2, 1)
            if x.shape == (r, h * per):
                return x.reshape(r, h, per).transpose(1, 0, 2)
        elif x.ndim == 3:
            if x.shape == (h, per, r):
                return x.transpose(0, 2, 1)
            if x.shape == (h, r, per):
                return x
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"cannot orient MLA split tensor of shape {x.shape} "
            f"(h={h}, r={r}, per={per})")

    def kv_b_for(i: int) -> np.ndarray:
        name = f"blk.{i}.attn_kv_b.weight"
        if name in gguf.tensors:
            return mat(name)  # (r, h * (nope + vd))
        fused = np.concatenate(
            [as3(vec(f"blk.{i}.attn_k_b.weight"), nope),
             as3(vec(f"blk.{i}.attn_v_b.weight"), vd)], axis=2)
        return np.ascontiguousarray(
            fused.transpose(1, 0, 2).reshape(r, h * (nope + vd)))

    attn: Dict[str, list] = {k: [] for k in (
        "attn_norm", "mlp_norm", "wkv_a", "kv_a_norm", "wkv_b", "wo",
        *(("wq_a", "q_a_norm", "wq_b") if cfg.q_lora_rank else ("wq",)))}
    dense_mlp: Dict[str, list] = {"w_gu": [], "w_down": []}
    moe_mlp: Dict[str, list] = {"moe_gate": [], "w_gu": [], "w_down": []}
    if cfg.moe_shared_hidden:
        moe_mlp.update(shared_gu=[], shared_down=[])
    if (cfg.n_experts
            and f"blk.{cfg.first_k_dense}.exp_probs_b.bias" in gguf.tensors):
        moe_mlp["moe_gate_bias"] = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        attn["attn_norm"].append(vec(f"{p}.attn_norm.weight"))
        attn["mlp_norm"].append(vec(f"{p}.ffn_norm.weight"))
        kv_a = mat(f"{p}.attn_kv_a_mqa.weight")               # (d, r+rope)
        if neox_rope:
            kv_a = _neox_to_interleaved_cols(kv_a, r, rope)
        attn["wkv_a"].append(kv_a)
        attn["kv_a_norm"].append(vec(f"{p}.attn_kv_a_norm.weight"))
        attn["wkv_b"].append(kv_b_for(i))
        attn["wo"].append(mat(f"{p}.attn_output.weight"))
        if cfg.q_lora_rank:
            attn["wq_a"].append(mat(f"{p}.attn_q_a.weight"))
            attn["q_a_norm"].append(vec(f"{p}.attn_q_a_norm.weight"))
            attn["wq_b"].append(fix_q_rope(mat(f"{p}.attn_q_b.weight")))
        else:
            attn["wq"].append(fix_q_rope(mat(f"{p}.attn_q.weight")))
        if i < cfg.first_k_dense or not cfg.n_experts:
            dense_mlp["w_gu"].append(np.concatenate(
                [mat(f"{p}.ffn_gate.weight"), mat(f"{p}.ffn_up.weight")],
                axis=1))
            dense_mlp["w_down"].append(mat(f"{p}.ffn_down.weight"))
            continue
        moe_mlp["moe_gate"].append(vec(f"{p}.ffn_gate_inp.weight").T)
        if "moe_gate_bias" in moe_mlp:
            moe_mlp["moe_gate_bias"].append(vec(f"{p}.exp_probs_b.bias"))
        g = vec(f"{p}.ffn_gate_exps.weight")
        u = vec(f"{p}.ffn_up_exps.weight")
        dn = vec(f"{p}.ffn_down_exps.weight")
        moe_mlp["w_gu"].append(np.concatenate(
            [g.transpose(0, 2, 1), u.transpose(0, 2, 1)], axis=2))
        moe_mlp["w_down"].append(np.ascontiguousarray(dn.transpose(0, 2, 1)))
        if cfg.moe_shared_hidden:
            moe_mlp["shared_gu"].append(np.concatenate(
                [mat(f"{p}.ffn_gate_shexp.weight"),
                 mat(f"{p}.ffn_up_shexp.weight")], axis=1))
            moe_mlp["shared_down"].append(mat(f"{p}.ffn_down_shexp.weight"))
        log.info("converted MLA layer %d/%d", i + 1, cfg.n_layers)

    tensor = _converter_tools(device, None, group, dtype)[0]
    tok_emb = vec("token_embd.weight")
    lm_head = (mat("output.weight") if "output.weight" in gguf.tensors
               else np.ascontiguousarray(tok_emb.T))
    params = {
        "tok_emb": tensor(tok_emb, dtype),
        "attn": _tree_on(attn, tensor, dtype),
        "dense_mlp": _tree_on(dense_mlp, tensor, dtype),
        "moe_mlp": _tree_on(moe_mlp, tensor, dtype),
        "out_norm": tensor(vec("output_norm.weight"), dtype),
        "lm_head": tensor(lm_head, dtype),
    }
    md = gguf.metadata
    stype = str(md.get("deepseek2.rope.scaling.type", "") or "")
    sfactor = float(md.get("deepseek2.rope.scaling.factor", 0.0) or 0.0)
    if stype == "yarn" and sfactor > 1.0:
        # yarn_log_multiplier (0.1 * mscale_all_dim) is not applied: with
        # the published mscale == mscale_all_dim the net attention factor
        # is 1.0, and the HF route gives the same tree.
        orig = int(md.get("deepseek2.rope.scaling.original_context_length",
                          0))
        params["rope_factors"] = mla_model.yarn_rope_factors(
            cfg, sfactor, orig).to(device)
    if bits is not None:
        params = mla_model.quantize_params(params, bits=bits, group=group)
    return params, cfg


def mamba_from_hf(state: Dict[str, Any], *, norm_eps: float = 1e-5,
                  max_seq: int = 4096, dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None) -> tuple:
    """A transformers Mamba state dict -> (params, MambaConfig) for
    ``models/mamba.py``: the geometry from the shapes, ``A_log`` and ``D``
    kept in f32 (the recurrence runs in f32)."""
    from trackiellm_tpu_torch.models.mamba import MambaConfig

    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    emb = A("backbone.embeddings.weight")
    vocab, dim = emb.shape
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("backbone.layers.")})
    d_inner = A("backbone.layers.0.mixer.in_proj.weight").shape[0] // 2
    cfg = MambaConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, d_inner=d_inner,
        d_state=A("backbone.layers.0.mixer.A_log").shape[1],
        d_conv=A("backbone.layers.0.mixer.conv1d.weight").shape[-1],
        dt_rank=A("backbone.layers.0.mixer.dt_proj.weight").shape[1],
        norm_eps=norm_eps, max_seq=max_seq)
    L: Dict[str, list] = {k: [] for k in (
        "norm", "w_in", "conv_w", "conv_b", "w_x", "w_dt", "b_dt", "A_log",
        "d", "w_out")}
    for i in range(n_layers):
        pre = f"backbone.layers.{i}.mixer"
        L["norm"].append(A(f"backbone.layers.{i}.norm.weight"))
        L["w_in"].append(A(f"{pre}.in_proj.weight").T)
        L["conv_w"].append(A(f"{pre}.conv1d.weight")[:, 0, :].T)  # (K, I)
        L["conv_b"].append(A(f"{pre}.conv1d.bias")
                           if f"{pre}.conv1d.bias" in state
                           else np.zeros(d_inner, np.float32))
        L["w_x"].append(A(f"{pre}.x_proj.weight").T)
        L["w_dt"].append(A(f"{pre}.dt_proj.weight").T)
        L["b_dt"].append(A(f"{pre}.dt_proj.bias"))
        L["A_log"].append(A(f"{pre}.A_log"))
        L["d"].append(A(f"{pre}.D"))
        L["w_out"].append(A(f"{pre}.out_proj.weight").T)
    tensor = _converter_tools(device, None, 0, dtype)[0]
    return {
        "tok_emb": tensor(emb, dtype),
        "layers": _tree_on(L, tensor, dtype, f32_keys=("A_log", "d")),
        "out_norm": tensor(A("backbone.norm_f.weight"), dtype),
        "lm_head": tensor(A("lm_head.weight").T if "lm_head.weight" in state
                          else np.ascontiguousarray(emb.T), dtype),
    }, cfg


def gguf_to_mamba_params(path: str, *, bits: Optional[int] = None,
                         group: int = 256, max_seq: Optional[int] = None,
                         dtype: torch.dtype = torch.float32,
                         device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``mamba`` GGUF -> (params on ``device``, MambaConfig),
    the port of the JAX package's route: the conv weight comes squeezed to
    (I, K) and ``ssm_a`` as -exp(A_log), so the transformers layout is
    rebuilt and :func:`mamba_from_hf` converts it; the ``mamba.ssm.*``
    geometry keys are checked against the tensors' shapes. ``bits`` 4/8
    requantizes through ``mamba.quantize_params``."""
    from trackiellm_tpu_torch.models.mamba import quantize_params

    device = default_device(device, "convert")
    gguf = read_gguf_header(path)
    arch = gguf.architecture or ""
    if arch != "mamba":
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: architecture {arch!r}, want 'mamba'")
    md = gguf.metadata

    def T(name: str) -> np.ndarray:
        return load_gguf_tensor(gguf, name)

    n_layers = int(md.get(
        "mamba.block_count",
        len({k.split(".")[1] for k in gguf.tensors if k.startswith("blk.")})))
    state: Dict[str, Any] = {
        "backbone.embeddings.weight": T("token_embd.weight"),
        "backbone.norm_f.weight": T("output_norm.weight"),
    }
    if "output.weight" in gguf.tensors:  # absent when tied
        state["lm_head.weight"] = T("output.weight")
    for i in range(n_layers):
        b, p = f"blk.{i}.", f"backbone.layers.{i}.mixer."
        state[f"backbone.layers.{i}.norm.weight"] = T(b + "attn_norm.weight")
        state[p + "in_proj.weight"] = T(b + "ssm_in.weight")
        state[p + "conv1d.weight"] = T(b + "ssm_conv1d.weight")[:, None, :]
        state[p + "conv1d.bias"] = T(b + "ssm_conv1d.bias")
        state[p + "x_proj.weight"] = T(b + "ssm_x.weight")
        state[p + "dt_proj.weight"] = T(b + "ssm_dt.weight")
        state[p + "dt_proj.bias"] = T(b + "ssm_dt.bias")
        a = T(b + "ssm_a")
        if np.any(a >= 0):
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: ssm_a has non-negative entries: llama.cpp stores "
                "-exp(A_log); refusing to mis-decode")
        state[p + "A_log"] = np.log(-a)
        state[p + "D"] = T(b + "ssm_d")
        state[p + "out_proj.weight"] = T(b + "ssm_out.weight")
    ctx = int(md.get("mamba.context_length", 4096))
    params, cfg = mamba_from_hf(
        state,
        norm_eps=float(md.get("mamba.attention.layer_norm_rms_epsilon",
                              1e-5)),
        max_seq=max_seq if max_seq is not None else min(ctx, 4096),
        dtype=dtype, device=device)
    checks = {"mamba.ssm.conv_kernel": cfg.d_conv,
              "mamba.ssm.inner_size": cfg.d_inner,
              "mamba.ssm.state_size": cfg.d_state,
              "mamba.ssm.time_step_rank": cfg.dt_rank,
              "mamba.embedding_length": cfg.dim,
              "mamba.block_count": cfg.n_layers}
    for key, ours in checks.items():
        if key in md and int(md[key]) != ours:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: {key}={md[key]} disagrees with tensor shapes "
                f"({ours})")
    if bits:
        params = quantize_params(params, bits=bits, group=group)
    return params, cfg


def mamba2_from_hf(state: Dict[str, Any], *, n_groups: int = 8,
                   norm_eps: float = 1e-5, max_seq: int = 4096,
                   dt_limit: tuple = (0.0, float("inf")),
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> tuple:
    """A transformers Mamba2 state dict -> (params, Mamba2Config) for
    ``models/mamba2.py``: heads from ``A_log``, ``conv_dim`` from
    ``conv1d``, d_inner = in_proj rows - conv_dim - heads; ``n_groups`` is
    not shape-derivable (the HF config's; published default 8). The SSM
    leaves and the gate norm stay f32."""
    from trackiellm_tpu_torch.models.mamba2 import Mamba2Config

    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    emb = A("backbone.embeddings.weight")
    vocab, dim = emb.shape
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("backbone.layers.")})
    h = A("backbone.layers.0.mixer.A_log").shape[0]
    conv_w0 = A("backbone.layers.0.mixer.conv1d.weight")
    conv_dim, k_conv = conv_w0.shape[0], conv_w0.shape[-1]
    proj_out = A("backbone.layers.0.mixer.in_proj.weight").shape[0]
    d_inner = proj_out - conv_dim - h
    if d_inner % h or (conv_dim - d_inner) % (2 * n_groups):
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"inconsistent mamba2 geometry: proj={proj_out} "
            f"conv_dim={conv_dim} heads={h} n_groups={n_groups}")
    cfg = Mamba2Config(vocab_size=vocab, dim=dim, n_layers=n_layers,
                       n_heads=h, head_dim=d_inner // h,
                       d_state=(conv_dim - d_inner) // (2 * n_groups),
                       n_groups=n_groups, d_conv=k_conv, norm_eps=norm_eps,
                       dt_limit=tuple(dt_limit), max_seq=max_seq)
    L: Dict[str, list] = {k: [] for k in (
        "norm", "w_in", "conv_w", "conv_b", "dt_bias", "A_log", "d",
        "gate_norm", "w_out")}
    has_b_in = "backbone.layers.0.mixer.in_proj.bias" in state
    if has_b_in:
        L["b_in"] = []
    for i in range(n_layers):
        pre = f"backbone.layers.{i}.mixer"
        L["norm"].append(A(f"backbone.layers.{i}.norm.weight"))
        L["w_in"].append(A(f"{pre}.in_proj.weight").T)
        if has_b_in:
            L["b_in"].append(A(f"{pre}.in_proj.bias"))
        L["conv_w"].append(A(f"{pre}.conv1d.weight")[:, 0, :].T)
        L["conv_b"].append(A(f"{pre}.conv1d.bias")
                           if f"{pre}.conv1d.bias" in state
                           else np.zeros(conv_dim, np.float32))
        L["dt_bias"].append(A(f"{pre}.dt_bias"))
        L["A_log"].append(A(f"{pre}.A_log"))
        L["d"].append(A(f"{pre}.D"))
        L["gate_norm"].append(A(f"{pre}.norm.weight"))
        L["w_out"].append(A(f"{pre}.out_proj.weight").T)
    tensor = _converter_tools(device, None, 0, dtype)[0]
    return {
        "tok_emb": tensor(emb, dtype),
        "layers": _tree_on(L, tensor, dtype, f32_keys=(
            "A_log", "d", "dt_bias", "gate_norm")),
        "out_norm": tensor(A("backbone.norm_f.weight"), dtype),
        "lm_head": tensor(A("lm_head.weight").T if "lm_head.weight" in state
                          else np.ascontiguousarray(emb.T), dtype),
    }, cfg


# ---------------------------------------------------------------------------
# Qwen3-Next (the hybrid Gated-DeltaNet / gated-attention family)
# ---------------------------------------------------------------------------

def qwen3_next_from_hf(state: Dict[str, Any],
                       config: Optional[Dict[str, Any]] = None, *,
                       max_seq: int = 512,
                       dtype: torch.dtype = torch.float32,
                       device: Optional[torch.device] = None) -> tuple:
    """A transformers ``Qwen3NextForCausalLM`` state dict -> (params on
    ``device``, Qwen3NextConfig) for ``models/qwen3next.py``.

    The fused projections un-fuse here (row slices, exact): the attention
    ``q_proj`` packs per head [query | gate] (kept fused; the model splits
    it per head); the DeltaNet ``in_proj_qkvz`` groups rows per key head
    as [q, k, v, z] and ``in_proj_ba`` as [b, a], both regrouped into the
    global wq/wk/wv/wz/wb/wa. Geometry comes from shapes, the layer kinds
    from tensor presence (``linear_attn`` or ``self_attn``); the
    linear-attention head splits and head_dim, which shapes do not give,
    from ``config`` (the HF config.json), which raises without them. The
    zero-centered norm weights are stored raw."""
    from trackiellm_tpu_torch.models.qwen3next import Qwen3NextConfig

    config = config or {}
    device = default_device(device, "convert a checkpoint")

    def A(name: str) -> np.ndarray:
        if name not in state:
            raise KeyError(name)
        return np.asarray(state[name], np.float32)

    emb = A("model.embed_tokens.weight")
    vocab, dim = emb.shape
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("model.layers.")})
    layer_types = tuple(
        "l" if f"model.layers.{i}.linear_attn.in_proj_qkvz.weight" in state
        else "f" for i in range(n_layers))
    if "l" not in layer_types or "f" not in layer_types:
        log.warning("qwen3_next: homogeneous layer_types %s — published "
                    "checkpoints interleave both", layer_types)
    li_lin = layer_types.index("l")
    li_full = layer_types.index("f") if "f" in layer_types else None
    hv = A(f"model.layers.{li_lin}.linear_attn.dt_bias").shape[0]
    conv_dim, _, conv_k = A(
        f"model.layers.{li_lin}.linear_attn.conv1d.weight").shape
    hk = int(config.get("linear_num_key_heads", 0))
    dk = int(config.get("linear_key_head_dim", 0))
    dv = int(config.get("linear_value_head_dim", 0))
    if not (hk and dk and dv):
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            "qwen3_next needs linear_num_key_heads / linear_key_head_dim / "
            "linear_value_head_dim from the HF config (head splits are not "
            "shape-derivable)")
    if conv_dim != 2 * hk * dk + hv * dv:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"conv1d carries {conv_dim} channels but the config geometry "
            f"gives {2 * hk * dk + hv * dv}")
    hd = int(config.get("head_dim", 0))
    n_heads = int(config.get("num_attention_heads", 0))
    n_kv = int(config.get("num_key_value_heads", 0))
    if li_full is not None:
        if not hd:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                "qwen3_next needs head_dim from the HF config (the fused "
                "[query|gate] q_proj hides it from shapes)")
        att = f"model.layers.{li_full}.self_attn"
        n_heads = n_heads or A(f"{att}.q_proj.weight").shape[0] // (2 * hd)
        n_kv = n_kv or A(f"{att}.k_proj.weight").shape[0] // hd
    elif not hd:
        hd = 16  # linear-only stacks never touch attention shapes
    moe_layers = [i for i in range(n_layers)
                  if f"model.layers.{i}.mlp.gate.weight" in state]
    moe_hidden = shared_hidden = hidden = n_experts = 0
    if moe_layers:
        e0 = f"model.layers.{moe_layers[0]}.mlp.experts"
        n_experts = _n_experts(state, e0 + ".")
        moe_hidden = A(f"{e0}.0.gate_proj.weight").shape[0]
        shared_hidden = A(f"model.layers.{moe_layers[0]}.mlp.shared_expert"
                          ".gate_proj.weight").shape[0]
    else:
        hidden = A("model.layers.0.mlp.gate_proj.weight").shape[0]
    cfg = Qwen3NextConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        layer_types=layer_types, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=hd,
        partial_rotary_factor=float(config.get("partial_rotary_factor",
                                               0.25)),
        rope_theta=float(config.get("rope_theta", 10000.0)),
        lin_k_heads=hk, lin_v_heads=hv, lin_dk=dk, lin_dv=dv,
        conv_k=conv_k, hidden_dim=hidden or moe_hidden, n_experts=n_experts,
        n_experts_used=int(config.get("num_experts_per_tok", 2)),
        moe_hidden=moe_hidden, shared_hidden=shared_hidden,
        norm_topk=bool(config.get("norm_topk_prob", True)),
        norm_eps=float(config.get("rms_norm_eps", 1e-6)), max_seq=max_seq)

    tensor = _converter_tools(device, None, 0, dtype)[0]

    def J(a):
        return tensor(a, dtype)
    rep = hv // hk
    gsz = 2 * dk + 2 * rep * dv
    layers = []
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        lp: Dict[str, Any] = {
            "attn_norm": J(A(f"{pre}.input_layernorm.weight")),
            "mlp_norm": J(A(f"{pre}.post_attention_layernorm.weight"))}
        if layer_types[i] == "f":
            ap = f"{pre}.self_attn"
            lp.update(wq=J(A(f"{ap}.q_proj.weight").T),   # [q|gate] a head
                      wk=J(A(f"{ap}.k_proj.weight").T),
                      wv=J(A(f"{ap}.v_proj.weight").T),
                      wo=J(A(f"{ap}.o_proj.weight").T),
                      q_norm=J(A(f"{ap}.q_norm.weight")),
                      k_norm=J(A(f"{ap}.k_norm.weight")))
        else:
            ap = f"{pre}.linear_attn"
            qkvz = A(f"{ap}.in_proj_qkvz.weight").reshape(hk, gsz, dim)
            ba = A(f"{ap}.in_proj_ba.weight").reshape(hk, 2 * rep, dim)
            q, k, v, z = np.split(qkvz, np.cumsum([dk, dk, rep * dv]), axis=1)
            b, a = np.split(ba, [rep], axis=1)
            for name, part in (("wq", q), ("wk", k), ("wv", v), ("wz", z),
                               ("wb", b), ("wa", a)):
                lp[name] = J(part.reshape(-1, dim).T)
            lp.update(conv_w=J(A(f"{ap}.conv1d.weight")[:, 0, :]),
                      dt_bias=J(A(f"{ap}.dt_bias")),
                      a_log=J(A(f"{ap}.A_log")),
                      o_norm=J(A(f"{ap}.norm.weight")),
                      wo=J(A(f"{ap}.out_proj.weight").T))
        if i in moe_layers:
            gu, down = _experts(A, f"{pre}.mlp.experts", n_experts)
            lp.update(moe_gate=J(A(f"{pre}.mlp.gate.weight").T),
                      w_gu=J(gu), w_down=J(down),
                      shared_gu=J(_gu_T(A, f"{pre}.mlp.shared_expert")),
                      shared_down=J(A(f"{pre}.mlp.shared_expert.down_proj"
                                      ".weight").T),
                      shared_gate=J(A(f"{pre}.mlp.shared_expert_gate"
                                      ".weight").T))
        else:
            lp.update(w_gu=J(_gu_T(A, f"{pre}.mlp")),
                      w_down=J(A(f"{pre}.mlp.down_proj.weight").T))
        layers.append(lp)
    return {"tok_emb": J(emb), "layers": layers,
            "out_norm": J(A("model.norm.weight")),
            "lm_head": J(_hf_head(state, A, emb))}, cfg


def _check_md(path: str, md: Dict[str, Any], key: str, ours: int) -> None:
    if key in md and int(md[key]) != ours:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: {key}={md[key]} disagrees with tensor shapes ({ours})")


def gguf_to_qwen3next_params(path: str, *, bits: Optional[int] = None,
                             group: int = 256, max_seq: int = 512,
                             dtype: torch.dtype = torch.float32,
                             device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp ``qwen3next`` GGUF -> (params on ``device``,
    Qwen3NextConfig): the transformers names and a config dict rebuilt
    from the file, then :func:`qwen3_next_from_hf` (the reference's
    route). Layer kinds from tensor presence (``blk.N.ssm_in``: DeltaNet,
    ``blk.N.attn_q``: attention). The attention gate is read in either
    layout by geometry: a separate ``attn_gate`` (re-interleaved per head
    into HF's fused [q | gate]) or an ``attn_q`` of 2 H hd rows. ``ssm_a``
    all negative is llama.cpp's -exp(A_log) and is inverted; anything else
    is the raw A_log (positive in HF's init). The DeltaNet geometry: Hv
    from ``ssm_dt.bias``, Hv dv from the qkvz rows less the conv width, dk
    from ``ssm.state_size`` (else dv, with a warning), Hk from the rest;
    the metadata keys that state them must agree. ``bits`` 4/8 requantizes
    through ``qwen3next.quantize_params``."""
    gguf = read_gguf_header(path)
    arch = gguf.architecture or ""
    if arch != "qwen3next":
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: architecture {arch!r}, want 'qwen3next'")
    md, t = gguf.metadata, gguf.tensors

    def T(name: str) -> np.ndarray:
        return load_gguf_tensor(gguf, name)

    n_layers = int(md.get(f"{arch}.block_count", len(
        {k.split(".")[1] for k in t if k.startswith("blk.")})))
    dim = int(md.get(f"{arch}.embedding_length",
                     t["token_embd.weight"].shape[1]))
    lin_layers = [i for i in range(n_layers) if f"blk.{i}.ssm_in.weight" in t]
    full_layers = [i for i in range(n_layers)
                   if f"blk.{i}.attn_q.weight" in t]
    if sorted(lin_layers + full_layers) != list(range(n_layers)):
        missing = sorted(set(range(n_layers)) - set(lin_layers)
                         - set(full_layers))
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: layers {missing} carry neither ssm_in nor attn_q")
    has_moe = any(f"blk.{i}.ffn_gate_exps.weight" in t
                  for i in range(n_layers))
    config: Dict[str, Any] = {
        "rms_norm_eps": float(md.get(
            f"{arch}.attention.layer_norm_rms_epsilon", 1e-6)),
        "rope_theta": (float(_math_key(
            md, f"{arch}.rope.freq_base", 10000.0,
            "llama.cpp default; published Qwen3-Next uses 1e7"))
            if full_layers else 10000.0),
        "num_experts_per_tok": (int(_math_key(
            md, f"{arch}.expert_used_count", 2,
            "qwen-MoE default; published Qwen3-Next routes top-10"))
            if has_moe else 2),
        "norm_topk_prob": True,
    }
    if lin_layers:
        li = lin_layers[0]
        hv = t[f"blk.{li}.ssm_dt.bias"].shape[0]
        qkvz_rows = t[f"blk.{li}.ssm_in.weight"].shape[0]
        conv_dim = t[f"blk.{li}.ssm_conv1d.weight"].shape[0]
        hv_dv = qkvz_rows - conv_dim
        if hv_dv <= 0 or hv_dv % hv:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: qkvz rows {qkvz_rows} / conv width {conv_dim} / "
                f"dt heads {hv} are inconsistent")
        dv = hv_dv // hv
        dk = int(_math_key(md, f"{arch}.ssm.state_size", dv,
                           "published Qwen3-Next uses square dk=dv heads"))
        hk2dk = conv_dim - hv * dv
        if hk2dk <= 0 or hk2dk % (2 * dk):
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: conv width {conv_dim} minus value channels "
                f"{hv * dv} is not a multiple of 2*dk={2 * dk}")
        hk = hk2dk // (2 * dk)
        config.update(linear_num_key_heads=hk, linear_key_head_dim=dk,
                      linear_value_head_dim=dv)
        _check_md(path, md, f"{arch}.ssm.group_count", hk)
        _check_md(path, md, f"{arch}.ssm.inner_size", hv * dv)
        _check_md(path, md, f"{arch}.ssm.conv_kernel",
                  t[f"blk.{li}.ssm_conv1d.weight"].shape[-1])
    if full_layers:
        n_heads = int(md.get(f"{arch}.attention.head_count", 0))
        n_kv = int(md.get(f"{arch}.attention.head_count_kv", n_heads))
        if not (n_heads and n_kv):
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: missing {arch}.attention.head_count[_kv]")
        hd = t[f"blk.{full_layers[0]}.attn_k.weight"].shape[0] // n_kv
        key = f"{arch}.attention.key_length"
        if key in md and int(md[key]) != hd:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: attention.key_length={md[key]} disagrees with "
                f"attn_k rows ({hd} per kv head)")
        config.update(num_attention_heads=n_heads, num_key_value_heads=n_kv,
                      head_dim=hd, partial_rotary_factor=float(_math_key(
                          md, f"{arch}.rope.dimension_count", 0.25 * hd,
                          "published Qwen3-Next partial rotary 0.25")) / hd)

    state: Dict[str, Any] = {
        "model.embed_tokens.weight": T("token_embd.weight"),
        "model.norm.weight": T("output_norm.weight")}
    if "output.weight" in t:
        state["lm_head.weight"] = T("output.weight")
    for i in range(n_layers):
        b, p = f"blk.{i}.", f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = T(b + "attn_norm.weight")
        state[p + "post_attention_layernorm.weight"] = T(
            b + "ffn_norm.weight")
        if i in lin_layers:
            la = p + "linear_attn."
            state[la + "in_proj_qkvz.weight"] = T(b + "ssm_in.weight")
            state[la + "in_proj_ba.weight"] = T(b + "ssm_beta_alpha.weight")
            state[la + "conv1d.weight"] = T(b + "ssm_conv1d.weight")[:, None]
            state[la + "dt_bias"] = T(b + "ssm_dt.bias")
            a = T(b + "ssm_a")
            if np.all(a < 0):
                a = np.log(-a)  # llama.cpp's mamba-style -exp(A_log)
                log.info("gguf qwen3next: ssm_a decoded as -exp(A_log) "
                         "(all-negative entries)")
            state[la + "A_log"] = a
            state[la + "norm.weight"] = T(b + "ssm_norm.weight")
            state[la + "out_proj.weight"] = T(b + "ssm_out.weight")
        else:
            sa = p + "self_attn."
            q = T(b + "attn_q.weight")
            hd, n_heads = config["head_dim"], config["num_attention_heads"]
            if f"blk.{i}.attn_gate.weight" in t:
                g = T(b + "attn_gate.weight")
                if q.shape[0] != n_heads * hd or g.shape != q.shape:
                    raise TrackieError(
                        ErrorCode.MODEL_METADATA_INVALID,
                        f"{path}: blk.{i} attn_q {q.shape} / attn_gate "
                        f"{g.shape} vs H={n_heads}, hd={hd}")
                q = np.concatenate([q.reshape(n_heads, hd, dim),
                                    g.reshape(n_heads, hd, dim)],
                                   axis=1).reshape(n_heads * 2 * hd, dim)
            elif q.shape[0] != n_heads * 2 * hd:
                raise TrackieError(
                    ErrorCode.MODEL_METADATA_INVALID,
                    f"{path}: blk.{i} attn_q rows {q.shape[0]} match neither "
                    f"the fused 2*H*hd={2 * n_heads * hd} nor the split "
                    f"H*hd={n_heads * hd} (+attn_gate) layout")
            state[sa + "q_proj.weight"] = q
            for hf, gg in (("k_proj", "attn_k"), ("v_proj", "attn_v"),
                           ("o_proj", "attn_output"),
                           ("q_norm", "attn_q_norm"),
                           ("k_norm", "attn_k_norm")):
                state[f"{sa}{hf}.weight"] = T(f"{b}{gg}.weight")
        if f"blk.{i}.ffn_gate_exps.weight" in t:
            g = T(b + "ffn_gate_exps.weight")
            u = T(b + "ffn_up_exps.weight")
            dn = T(b + "ffn_down_exps.weight")
            _check_md(path, md, f"{arch}.expert_count", g.shape[0])
            state[p + "mlp.gate.weight"] = T(b + "ffn_gate_inp.weight")
            for e in range(g.shape[0]):
                ep = p + f"mlp.experts.{e}."
                state[ep + "gate_proj.weight"] = g[e]
                state[ep + "up_proj.weight"] = u[e]
                state[ep + "down_proj.weight"] = dn[e]
            sp = p + "mlp.shared_expert."
            state[sp + "gate_proj.weight"] = T(b + "ffn_gate_shexp.weight")
            state[sp + "up_proj.weight"] = T(b + "ffn_up_shexp.weight")
            state[sp + "down_proj.weight"] = T(b + "ffn_down_shexp.weight")
            state[p + "mlp.shared_expert_gate.weight"] = T(
                b + "ffn_gate_inp_shexp.weight")
        else:
            for hf, gg in (("gate_proj", "ffn_gate"), ("up_proj", "ffn_up"),
                           ("down_proj", "ffn_down")):
                state[f"{p}mlp.{hf}.weight"] = T(f"{b}{gg}.weight")
    ctx = int(md.get(f"{arch}.context_length", max_seq))
    params, cfg = qwen3_next_from_hf(state, config,
                                     max_seq=min(ctx, max_seq), dtype=dtype,
                                     device=device)
    if bits:
        from trackiellm_tpu_torch.models.qwen3next import quantize_params

        params = quantize_params(params, bits=bits, group=group)
    return params, cfg


def qwen3next_params_from_jax(tree: Dict[str, Any], cfg,
                              device: Optional[torch.device] = None
                              ) -> Dict[str, Any]:
    """The JAX package's Qwen3-Next tree (dense, per-expert quantized
    stacks, or fused ``w_in``) as this package's, byte for byte: the same
    list of per-layer dicts (``models/bridge.py:params_from_jax``), each
    layer's keys checked against its kind in ``cfg.layer_types``."""
    from trackiellm_tpu_torch.models.bridge import params_from_jax

    device = default_device(device, "carry Qwen3-Next params")
    layers = tree["layers"]
    if len(layers) != len(cfg.layer_types):
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{len(layers)} layers for {len(cfg.layer_types)} layer types")
    for i, (lt, lp) in enumerate(zip(cfg.layer_types, layers)):
        want = "a_log" if lt == "l" else "q_norm"
        if want not in lp:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"layer {i} of kind {lt!r} has no {want!r} leaf")
    return params_from_jax(tree, device)


_ARCH_CONVERTERS = {
    "deepseek2": gguf_to_mla_params,
    "mamba": gguf_to_mamba_params,
    "falcon": gguf_to_falcon_params,
    "llama4": gguf_to_llama4_params,
    "glm4moe": gguf_to_glm4moe_params,
    "qwen3next": gguf_to_qwen3next_params,
}


def gguf_convert_auto(path: str, bits: Optional[int] = None,
                      device: Optional[torch.device] = None) -> tuple:
    """The arch -> converter dispatch for GGUF files that the CLI's
    ``convert`` uses (``trackiellm_tpu/models/convert.py:gguf_convert_auto``):
    deepseek2 (MLA), mamba, falcon, llama4, glm4moe and qwen3next take
    their own routes, every other arch :func:`gguf_to_llm_params`. Returns
    (params, cfg)."""
    arch = read_gguf_header(path).architecture or ""
    fn = _ARCH_CONVERTERS.get(arch, gguf_to_llm_params)
    return fn(path, bits=bits, device=device)


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


# ---------------------------------------------------------------------------
# Multimodal converters: LLaVA, PaliGemma, llama.cpp mmproj
# ---------------------------------------------------------------------------

def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A name -> array state dict from .pt/.pth/.bin (torch),
    .safetensors, .npz or .onnx (initializers only): the JAX package's
    ``tools/parity_common.load_state_dict`` over this package's readers."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pt", ".pth", ".bin"):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            for key in ("model_state_dict", "state_dict", "model"):
                if key in obj and isinstance(obj[key], dict):
                    obj = obj[key]
                    break
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        return {k: v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v) for k, v in obj.items()
                if hasattr(v, "shape") or hasattr(v, "detach")}
    if ext == ".safetensors":
        from trackiellm_tpu_torch.models.loader import load_safetensors
        return load_safetensors(path)
    if ext == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if ext == ".onnx":
        from trackiellm_tpu_torch.models.onnx_reader import (
            read_onnx_initializers)
        return read_onnx_initializers(path)
    raise TrackieError(ErrorCode.MODEL_FORMAT_UNKNOWN,
                       f"unsupported checkpoint format {ext!r} for {path}")


def _llm_tree(layers: Dict[str, list], emb: np.ndarray, out_norm: np.ndarray,
              lm_head: np.ndarray, dtype: torch.dtype, device: torch.device,
              bits: Optional[int], group: int) -> Dict[str, Any]:
    """The LLM tree from f32 host arrays, in ``dtype`` on ``device``; with
    ``bits`` (4, 8) requantized there as ``llm.quantize_params`` does."""
    tensor = _converter_tools(device, None, group, dtype)[0]
    params = {
        "tok_emb": tensor(emb, dtype),
        "layers": {k: tensor(np.stack(v), dtype) for k, v in layers.items()},
        "out_norm": tensor(out_norm, dtype),
        "lm_head": tensor(lm_head, dtype),
    }
    if bits:
        params = llm_model.quantize_params(params, bits=bits, group=group)
    return params


def smollm3_from_hf(state: Dict[str, Any], *, max_seq: int = 65536,
                    norm_eps: float = 1e-6, rope_theta: float = 5e6,
                    nope_pattern: int = 4, head_dim: int = 0,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None,
                    bits: Optional[int] = None, group: int = 256) -> tuple:
    """A transformers Llama-shaped state dict (SmolLM3's, or LLaVA's text
    half with ``nope_pattern=0``) -> (params, LLMConfig): RMSNorm, SwiGLU,
    GQA, no biases, lm_head or the tied embedding. ``head_dim`` is not
    shape-derivable; the default is 128 (the Llama convention at the
    published sizes)."""
    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    emb = A("model.embed_tokens.weight")
    vocab, dim = emb.shape
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("model.layers.")})
    hd = head_dim or 128
    n_heads = A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd
    n_kv = A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd
    hidden = A("model.layers.0.mlp.gate_proj.weight").shape[0]
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd, hidden_dim=hidden, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq, sliding_window=max_seq,
        nope_pattern=nope_pattern)
    return _llm_tree(_llama_layers(A, n_layers), emb, A("model.norm.weight"),
                     _hf_head(state, A, emb), dtype, device, bits,
                     group), cfg


def gemma_from_hf(state: Dict[str, Any], *, head_dim: int = 256,
                  max_seq: int = 8192, norm_eps: float = 1e-6,
                  rope_theta: float = 10000.0, prefix: str = "model.",
                  head_key: str = "lm_head.weight",
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None,
                  bits: Optional[int] = None, group: int = 256) -> tuple:
    """A transformers Gemma-1 state dict -> (params, LLMConfig): the Llama
    template with GeGLU (tanh), the (1+w) RMSNorm fold, the sqrt(dim)
    embedding scale folded into tok_emb (lm_head keeps the unscaled tied
    copy) and an explicit head_dim (256 at both published sizes). Also
    PaliGemma's text half (``prefix="model.language_model."``)."""
    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    P = prefix
    emb = A(P + "embed_tokens.weight")
    vocab, dim = emb.shape
    n_layers = len({k[len(P) + len("layers."):].split(".")[0]
                    for k in state if k.startswith(P + "layers.")})
    hd = head_dim
    n_heads = A(P + "layers.0.self_attn.q_proj.weight").shape[0] // hd
    n_kv = A(P + "layers.0.self_attn.k_proj.weight").shape[0] // hd
    hidden = A(P + "layers.0.mlp.gate_proj.weight").shape[0]
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd, hidden_dim=hidden, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq, sliding_window=max_seq,
        act="gelu")
    L: Dict[str, list] = {k: [] for k in ("attn_norm", "wqkv", "wo",
                                          "mlp_norm", "w_gu", "w_down")}
    for i in range(n_layers):
        pre = f"{P}layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight") + 1.0)
        L["mlp_norm"].append(
            A(f"{pre}.post_attention_layernorm.weight") + 1.0)
        L["wqkv"].append(np.concatenate(
            [A(f"{pre}.self_attn.{p}_proj.weight").T
             for p in ("q", "k", "v")], axis=1))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(np.concatenate(
            [A(f"{pre}.mlp.gate_proj.weight").T,
             A(f"{pre}.mlp.up_proj.weight").T], axis=1))
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    lm_head = (A(head_key).T if head_key in state
               else np.ascontiguousarray(emb.T))
    return _llm_tree(L, emb * float(np.sqrt(dim)), A(P + "norm.weight") + 1.0,
                     lm_head, dtype, device, bits, group), cfg


_VISION_LEAVES = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "wq", "bq", "wk", "bk",
                  "wv", "bv", "wo", "bo", "w1", "b1", "w2", "b2")


def _hf_vision_layers(A, vt: str, n_layers: int) -> Dict[str, list]:
    """A transformers CLIP/SigLIP encoder's layers as models/clip.py's
    stacked leaves ((in, out) matrices)."""
    L: Dict[str, list] = {k: [] for k in _VISION_LEAVES}
    for i in range(n_layers):
        pre = f"{vt}encoder.layers.{i}"
        L["ln1_g"].append(A(f"{pre}.layer_norm1.weight"))
        L["ln1_b"].append(A(f"{pre}.layer_norm1.bias"))
        L["ln2_g"].append(A(f"{pre}.layer_norm2.weight"))
        L["ln2_b"].append(A(f"{pre}.layer_norm2.bias"))
        for p in ("q", "k", "v"):
            L[f"w{p}"].append(A(f"{pre}.self_attn.{p}_proj.weight").T)
            L[f"b{p}"].append(A(f"{pre}.self_attn.{p}_proj.bias"))
        L["wo"].append(A(f"{pre}.self_attn.out_proj.weight").T)
        L["bo"].append(A(f"{pre}.self_attn.out_proj.bias"))
        L["w1"].append(A(f"{pre}.mlp.fc1.weight").T)
        L["b1"].append(A(f"{pre}.mlp.fc1.bias"))
        L["w2"].append(A(f"{pre}.mlp.fc2.weight").T)
        L["b2"].append(A(f"{pre}.mlp.fc2.bias"))
    return L


def _vision_tree(tree: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device) -> Dict[str, Any]:
    """A host tree of f32 arrays (stacked-layer lists included) on
    ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _vision_tree(v, dtype, device) for k, v in tree.items()}
    a = np.stack(tree) if isinstance(tree, list) else tree
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device).to(dtype)


def _hf_multimodal_prefixes(state: Dict[str, Any]) -> tuple:
    """(vision tower, language model, projector, lm_head key) prefixes of
    the transformers >= 4.52 layout or the legacy one."""
    if any(k.startswith("model.vision_tower.") for k in state):
        return ("model.vision_tower.vision_model.", "model.language_model.",
                "model.multi_modal_projector.", "lm_head.weight")
    return ("vision_tower.vision_model.", "language_model.model.",
            "multi_modal_projector.", "language_model.lm_head.weight")


def _n_vision_layers(state: Dict[str, Any], vt: str) -> int:
    return len({k[len(vt) + len("encoder.layers."):].split(".")[0]
                for k in state if k.startswith(vt + "encoder.layers.")})


def llava_from_hf(state: Dict[str, Any], *, n_heads: int,
                  max_seq: int = 4096, norm_eps: float = 1e-5,
                  rope_theta: float = 1e4, vision_n_heads: int = 16,
                  vision_act: str = "quick_gelu",
                  vision_norm_eps: float = 1e-5, feature_layer: int = -2,
                  drop_cls: bool = True, proj_act: str = "gelu",
                  dtype: torch.dtype = torch.bfloat16,
                  vision_dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None,
                  bits: Optional[int] = None, group: int = 256) -> tuple:
    """A transformers LLaVA state dict -> ``(llm_params, llm_cfg,
    clip_params, clip_cfg)``: the Llama-family language model in this
    package's fused layout and the CLIP tower + projector of
    models/clip.py. Both transformers layouts (>= 4.52's
    ``model.vision_tower.*`` and the legacy ``vision_tower.*``) are read.
    The vision geometry comes from shapes; ``n_heads`` and
    ``vision_n_heads`` come from the HF config."""
    from trackiellm_tpu_torch.models import clip as clip_model

    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    vt, lm, proj, head_key = _hf_multimodal_prefixes(state)
    text_state = {"model." + k[len(lm):]: v for k, v in state.items()
                  if k.startswith(lm)}
    if head_key in state:
        text_state["lm_head.weight"] = state[head_key]
    dim = A(lm + "embed_tokens.weight").shape[1]
    llm_params, llm_cfg = smollm3_from_hf(
        text_state, max_seq=max_seq, norm_eps=norm_eps,
        rope_theta=rope_theta, nope_pattern=0, head_dim=dim // n_heads,
        dtype=dtype, device=device, bits=bits, group=group)

    pw = A(vt + "embeddings.patch_embedding.weight")  # (D, 3, P, P)
    vdim, _, patch, _ = pw.shape
    pos = A(vt + "embeddings.position_embedding.weight")  # (N + 1, D)
    n_vlayers = _n_vision_layers(state, vt)
    clip_cfg = clip_model.CLIPVisionConfig(
        image_size=patch * int(round((pos.shape[0] - 1) ** 0.5)),
        patch_size=patch, dim=vdim, n_layers=n_vlayers,
        n_heads=vision_n_heads,
        hidden_dim=A(vt + "encoder.layers.0.mlp.fc1.weight").shape[0],
        norm_eps=vision_norm_eps, act=vision_act,
        feature_layer=feature_layer, drop_cls=drop_cls, proj_dim=dim,
        proj_act=proj_act)
    clip_params = _vision_tree({
        # (D, 3, P, P) -> (3*P*P, D): the (c, ph, pw) order of
        # encode_image's patch extraction.
        "patch_w": pw.reshape(vdim, -1).T,
        "cls": A(vt + "embeddings.class_embedding"),
        "pos": pos,
        "pre_ln_g": A(vt + "pre_layrnorm.weight"),
        "pre_ln_b": A(vt + "pre_layrnorm.bias"),
        "layers": _hf_vision_layers(A, vt, n_vlayers),
        "proj": {"w1": A(proj + "linear_1.weight").T,
                 "b1": A(proj + "linear_1.bias"),
                 "w2": A(proj + "linear_2.weight").T,
                 "b2": A(proj + "linear_2.bias")},
    }, vision_dtype, device)
    return llm_params, llm_cfg, clip_params, clip_cfg


def paligemma_from_hf(state: Dict[str, Any], *, head_dim: int = 256,
                      max_seq: int = 8192, norm_eps: float = 1e-6,
                      rope_theta: float = 10000.0, vision_n_heads: int = 16,
                      vision_norm_eps: float = 1e-6,
                      dtype: torch.dtype = torch.bfloat16,
                      vision_dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = None,
                      bits: Optional[int] = None, group: int = 256) -> tuple:
    """A transformers PaliGemma state dict -> ``(llm_params, llm_cfg,
    clip_params, clip_cfg)``: the SigLIP tower (no CLS, patch bias, no
    pre-LN, the post-LN tap, tanh-GELU), a single-linear projector and the
    Gemma-1 text model (:func:`gemma_from_hf`). HF divides the projected
    features by sqrt(text_dim) and GemmaModel multiplies every input
    embedding by it, so with the scale folded into tok_emb the projector's
    output goes in unscaled. PaliGemma is a prefix-LM: drive it with
    ``VLMRunner(prefix_lm=True)``."""
    from trackiellm_tpu_torch.models import clip as clip_model

    device = default_device(device, "convert a checkpoint")
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    vt, lm, proj, head_key = _hf_multimodal_prefixes(state)
    llm_params, llm_cfg = gemma_from_hf(
        state, head_dim=head_dim, max_seq=max_seq, norm_eps=norm_eps,
        rope_theta=rope_theta, prefix=lm, head_key=head_key, dtype=dtype,
        device=device, bits=bits, group=group)

    pw = A(vt + "embeddings.patch_embedding.weight")  # (D, 3, P, P)
    vdim, _, patch, _ = pw.shape
    pos = A(vt + "embeddings.position_embedding.weight")  # (N, D)
    n_vlayers = _n_vision_layers(state, vt)
    clip_cfg = clip_model.CLIPVisionConfig(
        image_size=patch * int(round(pos.shape[0] ** 0.5)),
        patch_size=patch, dim=vdim, n_layers=n_vlayers,
        n_heads=vision_n_heads,
        hidden_dim=A(vt + "encoder.layers.0.mlp.fc1.weight").shape[0],
        norm_eps=vision_norm_eps, act="gelu_pytorch_tanh", feature_layer=-1,
        drop_cls=False, use_cls=False, patch_bias=True, pre_ln=False,
        post_ln=True, proj_dim=A(proj + "linear.weight").shape[0],
        proj_layers=1)
    clip_params = _vision_tree({
        "patch_w": pw.reshape(vdim, -1).T,
        "patch_b": A(vt + "embeddings.patch_embedding.bias"),
        "pos": pos,
        "post_ln_g": A(vt + "post_layernorm.weight"),
        "post_ln_b": A(vt + "post_layernorm.bias"),
        "layers": _hf_vision_layers(A, vt, n_vlayers),
        "proj": {"w1": A(proj + "linear.weight").T,
                 "b1": A(proj + "linear.bias")},
    }, vision_dtype, device)
    return llm_params, llm_cfg, clip_params, clip_cfg


# Full CLIP/SigLIP tower depths: an mmproj with one of these block counts
# and no feature-layer metadata may run its tap a block late.
_FULL_TOWER_DEPTHS = (12, 24, 26, 27, 32)


def gguf_to_clip_params(path: str, *,
                        vision_dtype: torch.dtype = torch.float32,
                        device: Optional[torch.device] = None) -> tuple:
    """A llama.cpp "mmproj" CLIP GGUF -> (clip_params, CLIPVisionConfig)
    on ``device``: the vision half of llama.cpp's LLaVA packaging (a text
    GGUF + an mmproj file).

    Tensor names are clip.cpp's (``v.patch_embd.weight``,
    ``v.blk.%d.attn_{q,k,v}/attn_out/ln1/ln2/ffn_{up,down}``, ``mm.0`` and
    ``mm.2`` projector); the geometry comes from ``clip.vision.*``
    metadata, checked against the tensors' shapes. The two MLP matrices
    are told apart by shape ((hidden, dim) is fc1), since converters have
    swapped the ffn_up/ffn_down names. An mmproj usually stops at LLaVA's
    feature tap (ViT-L ships 23 of 24 blocks), so every stored block runs
    unless ``clip.vision.feature_layer`` says otherwise (k > 0 runs k
    blocks; k < 0 runs n_layers + 1 + k)."""
    from trackiellm_tpu_torch.models import clip as clip_model

    device = default_device(device, "convert a checkpoint")
    gguf = read_gguf_header(path)
    md = gguf.metadata
    if not (md.get("clip.has_vision_encoder", True)
            and "v.patch_embd.weight" in gguf.tensors):
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"{path}: not a clip.cpp vision mmproj file")

    def T(name: str) -> np.ndarray:
        return np.asarray(load_gguf_tensor(gguf, name), np.float32)

    pw = T("v.patch_embd.weight")          # OIHW, as the HF conv
    vdim, _, patch, _ = pw.shape
    pos = T("v.position_embd.weight")      # (N + 1, D), CLS included
    image_size = patch * int(round((pos.shape[0] - 1) ** 0.5))
    n_layers = len({k.split(".")[2] for k in gguf.tensors
                    if k.startswith("v.blk.")})
    checks = {"clip.vision.image_size": image_size,
              "clip.vision.patch_size": patch,
              "clip.vision.embedding_length": vdim,
              "clip.vision.block_count": n_layers}
    for key, ours in checks.items():
        if key in md and int(md[key]) != ours:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: {key}={md[key]} disagrees with tensor shapes "
                f"({ours})")

    def fc_pair(i: int):
        """The MLP matrices by shape, not by clip.cpp's names."""
        a, a_b = T(f"v.blk.{i}.ffn_up.weight"), T(f"v.blk.{i}.ffn_up.bias")
        b, b_b = (T(f"v.blk.{i}.ffn_down.weight"),
                  T(f"v.blk.{i}.ffn_down.bias"))
        if a.shape[1] == vdim and a.shape[0] != vdim:
            return a, a_b, b, b_b
        if b.shape[1] == vdim and b.shape[0] != vdim:
            return b, b_b, a, a_b
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"{path}: blk.{i} MLP shapes {a.shape}/{b.shape} don't "
            f"disambiguate against dim={vdim}")

    L: Dict[str, list] = {k: [] for k in _VISION_LEAVES}
    for i in range(n_layers):
        pre = f"v.blk.{i}"
        L["ln1_g"].append(T(f"{pre}.ln1.weight"))
        L["ln1_b"].append(T(f"{pre}.ln1.bias"))
        L["ln2_g"].append(T(f"{pre}.ln2.weight"))
        L["ln2_b"].append(T(f"{pre}.ln2.bias"))
        for ours, theirs in (("q", "attn_q"), ("k", "attn_k"),
                             ("v", "attn_v")):
            L[f"w{ours}"].append(T(f"{pre}.{theirs}.weight").T)
            L[f"b{ours}"].append(T(f"{pre}.{theirs}.bias"))
        L["wo"].append(T(f"{pre}.attn_out.weight").T)
        L["bo"].append(T(f"{pre}.attn_out.bias"))
        w1, b1, w2, b2 = fc_pair(i)
        L["w1"].append(w1.T)
        L["b1"].append(b1)
        L["w2"].append(w2.T)
        L["b2"].append(b2)

    feature_layer = n_layers
    if "clip.vision.feature_layer" in md:
        fl = int(md["clip.vision.feature_layer"])
        feature_layer = fl if fl > 0 else n_layers + 1 + fl
        if not 1 <= feature_layer <= n_layers:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"{path}: clip.vision.feature_layer={fl} resolves to "
                f"{feature_layer} of {n_layers} stored blocks")
    elif n_layers in _FULL_TOWER_DEPTHS:
        log.warning(
            "%s: mmproj stores %d blocks (a full tower depth) with no "
            "clip.vision.feature_layer metadata; running all of them; if "
            "features look wrong, the tap likely belongs at block %d",
            path, n_layers, n_layers - 1)

    proj_w1, proj_w2 = T("mm.0.weight"), T("mm.2.weight")
    clip_cfg = clip_model.CLIPVisionConfig(
        image_size=image_size, patch_size=patch, dim=vdim,
        n_layers=n_layers,
        n_heads=int(md.get("clip.vision.attention.head_count", 16)),
        hidden_dim=fc_pair(0)[0].shape[0],
        norm_eps=float(md.get("clip.vision.attention.layer_norm_epsilon",
                              1e-5)),
        act="gelu" if md.get("clip.use_gelu", False) else "quick_gelu",
        feature_layer=feature_layer, drop_cls=True,
        proj_dim=proj_w2.shape[0], proj_act="gelu")
    clip_params = _vision_tree({
        "patch_w": pw.reshape(vdim, -1).T,
        "cls": T("v.class_embd").reshape(-1),
        "pos": pos,
        "pre_ln_g": T("v.pre_ln.weight"),
        "pre_ln_b": T("v.pre_ln.bias"),
        "layers": L,
        "proj": {"w1": proj_w1.T, "b1": T("mm.0.bias"),
                 "w2": proj_w2.T, "b2": T("mm.2.bias")},
    }, vision_dtype, device)
    return clip_params, clip_cfg


# ---------------------------------------------------------------------------
# Perception models: the BERT embedder, TrOCR, AST, the CNN sound classifier
# ---------------------------------------------------------------------------

_BERT_LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                    "attn_norm_g", "attn_norm_b", "wi", "bi", "wd", "bd",
                    "out_norm_g", "out_norm_b")


def bert_from_hf(state: Dict[str, Any], pooling: str = "mean",
                 device: Optional[torch.device] = None):
    """``transformers.BertModel`` state dict (optionally "bert."-prefixed,
    e.g. a BertForMaskedLM dump) -> (params, EmbedderConfig) for
    models/embedder, in f32 on ``device`` (the CUDA card by default).
    Covers the sentence-transformers zoo (all-MiniLM, BGE, GTE small/base:
    llama.cpp's `bert` arch, the `llama-embedding` model family)."""
    from trackiellm_tpu_torch.models.embedder import EmbedderConfig

    device = default_device(device, "convert")
    if "bert.embeddings.word_embeddings.weight" in state:
        # BertForSequenceClassification/MaskedLM dump: strip the "bert."
        # prefix but keep the top-level classifier head (the reranker's
        # score head).
        state = {(k[len("bert."):] if k.startswith("bert.") else k): v
                 for k, v in state.items()}

    def A(name):
        return _f32(state[name])

    word = A("embeddings.word_embeddings.weight")
    pos = A("embeddings.position_embeddings.weight")
    typ = A("embeddings.token_type_embeddings.weight")
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in state:
        n_layers += 1
    hidden = word.shape[1]
    inter = int(A("encoder.layer.0.intermediate.dense.weight").shape[0])
    # Head count is not in the weights; every published BERT uses
    # hidden/64 heads (MiniLM 384/12 included) unless overridden.
    n_heads = max(1, hidden // 64)

    L: Dict[str, list] = {k: [] for k in _BERT_LAYER_KEYS}
    for i in range(n_layers):
        pre = f"encoder.layer.{i}"
        for short, name in (("q", "attention.self.query"),
                            ("k", "attention.self.key"),
                            ("v", "attention.self.value"),
                            ("o", "attention.output.dense"),
                            ("i", "intermediate.dense"),
                            ("d", "output.dense")):
            L[f"w{short}"].append(A(f"{pre}.{name}.weight").T)
            L[f"b{short}"].append(A(f"{pre}.{name}.bias"))
        for ours, theirs in (("attn_norm", "attention.output.LayerNorm"),
                             ("out_norm", "output.LayerNorm")):
            L[f"{ours}_g"].append(A(f"{pre}.{theirs}.weight"))
            L[f"{ours}_b"].append(A(f"{pre}.{theirs}.bias"))

    cfg = EmbedderConfig(
        vocab_size=word.shape[0], hidden=hidden, n_layers=n_layers,
        n_heads=n_heads, intermediate=inter, max_pos=pos.shape[0],
        type_vocab=typ.shape[0], pooling=pooling)
    tree = {
        "word_emb": word, "pos_emb": pos, "type_emb": typ,
        "emb_norm": {"g": A("embeddings.LayerNorm.weight"),
                     "b": A("embeddings.LayerNorm.bias")},
        "layers": L,
        "pooler": ({"w": A("pooler.dense.weight").T,
                    "b": A("pooler.dense.bias")}
                   if "pooler.dense.weight" in state else
                   {"w": np.eye(hidden, dtype=np.float32),
                    "b": np.zeros((hidden,), np.float32)}),
    }
    if "classifier.weight" in state:
        # Reranker / sequence-classification head: scores come from
        # classifier(pooler(CLS)), llama.cpp's cls.output.
        tree["cls_out"] = {"w": A("classifier.weight").T,
                           "b": A("classifier.bias")}
    return _vision_tree(tree, torch.float32, device), cfg


def gguf_to_bert_params(path: str, pooling: Optional[str] = None,
                        device: Optional[torch.device] = None):
    """llama.cpp ``bert``-architecture GGUF (all-MiniLM/BGE embedding
    checkpoints, `llama-embedding`) -> (params, EmbedderConfig,
    WordPieceTokenizer | None), params in f32 on ``device``.

    Tensor names (llama.cpp constants): token_embd / token_types /
    position_embd / token_embd_norm, blk.{i}.attn_{q,k,v,output}(+bias),
    attn_output_norm, ffn_{up,down}(+bias), layer_output_norm. Pooling
    comes from ``{arch}.pooling_type`` (1=mean, 2=cls) unless
    overridden."""
    from trackiellm_tpu_torch.llm.tokenizer import WordPieceTokenizer
    from trackiellm_tpu_torch.models.embedder import EmbedderConfig

    device = default_device(device, "convert")
    gguf = read_gguf_header(path)
    md = gguf.metadata
    arch = gguf.architecture or "bert"

    def get(key, default=None):
        return md.get(f"{arch}.{key}", default)

    hidden = int(get("embedding_length"))
    n_layers = int(get("block_count"))
    n_heads = int(get("attention.head_count", max(1, hidden // 64)))
    inter = int(get("feed_forward_length"))
    eps = float(get("attention.layer_norm_epsilon", 1e-12))
    max_pos = int(get("context_length", 512))
    if pooling is None:
        pooling = {1: "mean", 2: "cls"}.get(
            int(md.get(f"{arch}.pooling_type", 1) or 1), "mean")

    def T(name):
        return _f32(load_gguf_tensor(gguf, name))

    def opt(name, shape):
        return T(name) if name in gguf.tensors else np.zeros(shape,
                                                             np.float32)

    word = T("token_embd.weight")
    L: Dict[str, list] = {k: [] for k in _BERT_LAYER_KEYS}
    for i in range(n_layers):
        pre = f"blk.{i}"
        for short, name, width in (("q", "attn_q", hidden),
                                   ("k", "attn_k", hidden),
                                   ("v", "attn_v", hidden),
                                   ("o", "attn_output", hidden),
                                   ("i", "ffn_up", inter),
                                   ("d", "ffn_down", hidden)):
            L[f"w{short}"].append(T(f"{pre}.{name}.weight").T)
            L[f"b{short}"].append(opt(f"{pre}.{name}.bias", (width,)))
        for ours, theirs in (("attn_norm", "attn_output_norm"),
                             ("out_norm", "layer_output_norm")):
            L[f"{ours}_g"].append(T(f"{pre}.{theirs}.weight"))
            L[f"{ours}_b"].append(T(f"{pre}.{theirs}.bias"))

    typ = opt("token_types.weight", (2, hidden))
    cfg = EmbedderConfig(
        vocab_size=word.shape[0], hidden=hidden, n_layers=n_layers,
        n_heads=n_heads, intermediate=inter, max_pos=max_pos,
        type_vocab=typ.shape[0], eps=eps, pooling=pooling)
    tree = {
        "word_emb": word, "pos_emb": T("position_embd.weight"),
        "type_emb": typ,
        "emb_norm": {"g": T("token_embd_norm.weight"),
                     "b": T("token_embd_norm.bias")},
        "layers": L,
        "pooler": {"w": np.eye(hidden, dtype=np.float32),
                   "b": np.zeros((hidden,), np.float32)},
    }
    rank = ("cls.weight", "cls.bias", "cls.output.weight", "cls.output.bias")
    if all(name in gguf.tensors for name in rank):
        # Reranker checkpoints: cls dense (tanh) + cls.output score.
        tree["pooler"] = {"w": T("cls.weight").T, "b": T("cls.bias")}
        tree["cls_out"] = {"w": T("cls.output.weight").T,
                           "b": T("cls.output.bias")}
    tokenizer = None
    if (md.get("tokenizer.ggml.model") == "bert"
            and md.get("tokenizer.ggml.tokens")):
        def mi(key, alt=None):
            v = md.get(key, md.get(alt) if alt else None)
            return None if v is None else int(v)

        tokenizer = WordPieceTokenizer(
            list(md["tokenizer.ggml.tokens"]),
            unk_id=mi("tokenizer.ggml.unknown_token_id"),
            cls_id=mi("tokenizer.ggml.cls_token_id",
                      "tokenizer.ggml.bos_token_id"),
            sep_id=mi("tokenizer.ggml.seperator_token_id",
                      "tokenizer.ggml.eos_token_id"),
            pad_id=mi("tokenizer.ggml.padding_token_id"))
    return _vision_tree(tree, torch.float32, device), cfg, tokenizer


def _vit_stack(A, pre: str, n: int) -> Dict[str, list]:
    """An HF ViT/DeiT/AST encoder's layers ``{pre}.{i}.*`` as stacked
    lists in models/trocr.py's ``_vit_layer`` names."""
    L: Dict[str, list] = {k: [] for k in (
        "ln1_g", "ln1_b", "ln2_g", "ln2_b", "wq", "bq", "wk", "bk", "wv",
        "bv", "wo", "bo", "w1", "b1", "w2", "b2")}
    for i in range(n):
        for ours, theirs in (("ln1", "layernorm_before"),
                             ("ln2", "layernorm_after")):
            L[f"{ours}_g"].append(A(f"{pre}.{i}.{theirs}.weight"))
            L[f"{ours}_b"].append(A(f"{pre}.{i}.{theirs}.bias"))
        for ours, theirs in (("q", "attention.attention.query"),
                             ("k", "attention.attention.key"),
                             ("v", "attention.attention.value"),
                             ("o", "attention.output.dense"),
                             ("1", "intermediate.dense"),
                             ("2", "output.dense")):
            L[f"w{ours}"].append(A(f"{pre}.{i}.{theirs}.weight").T)
            L[f"b{ours}"].append(A(f"{pre}.{i}.{theirs}.bias"))
    return L


def _strict(state: Dict[str, Any]):
    """A state dict reader that names a missing key."""
    def A(name: str) -> np.ndarray:
        if name not in state:
            raise KeyError(name)
        return _f32(state[name])
    return A


def trocr_from_hf(state: Dict[str, Any],
                  config: Optional[Dict[str, Any]] = None, *,
                  enc_heads: Optional[int] = None,
                  dec_heads: Optional[int] = None, max_len: int = 64,
                  dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None):
    """HF TrOCR (``VisionEncoderDecoderModel``: ViT/DeiT encoder + TrOCR
    decoder, microsoft/trocr-{small,base,large}-{printed,handwritten})
    state dict -> (params, TrOCRConfig) for models/trocr.py, on ``device``
    (the CUDA card by default).

    Geometry is shape-derived (patch size, dims, layer counts, DeiT
    distillation token); head counts and special ids come from ``config``
    (the HF config dict) or the explicit arguments."""
    from trackiellm_tpu_torch.models.trocr import TrOCRConfig

    device = default_device(device, "convert")
    config = config or {}
    enc_cfg = config.get("encoder", {})
    dec_cfg = config.get("decoder", {})
    A = _strict(state)

    # --- encoder geometry from shapes ---
    pw = A("encoder.embeddings.patch_embeddings.projection.weight")
    enc_dim, in_ch, ps, _ = pw.shape
    pos = A("encoder.embeddings.position_embeddings")[0]  # (S, D)
    has_dist = "encoder.embeddings.distillation_token" in state
    n_prefix = 2 if has_dist else 1
    n_patches = pos.shape[0] - n_prefix
    image_size = ps * int(round(n_patches ** 0.5))
    if image_size // ps * (image_size // ps) != n_patches:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"non-square patch grid: {n_patches} patches of {ps}px")
    n_enc = len({k.split(".")[3] for k in state
                 if k.startswith("encoder.encoder.layer.")})
    n_dec = len({k.split(".")[4] for k in state
                 if k.startswith("decoder.model.decoder.layers.")})
    emb = A("decoder.model.decoder.embed_tokens.weight")
    vocab, d_model = emb.shape
    ffn = A("decoder.model.decoder.layers.0.fc1.weight").shape[0]
    dec_pos = A("decoder.model.decoder.embed_positions.weight")
    ln_emb = "decoder.model.decoder.layernorm_embedding.weight" in state

    e_heads = enc_heads or int(enc_cfg.get("num_attention_heads") or
                               {192: 3, 384: 6, 768: 12, 1024: 16}
                               .get(enc_dim, 12))
    d_heads = dec_heads or int(dec_cfg.get("decoder_attention_heads") or
                               {256: 8, 512: 8, 1024: 16}
                               .get(d_model, 16))
    cfg = TrOCRConfig(
        image_size=int(enc_cfg.get("image_size", image_size)),
        patch_size=ps, enc_dim=enc_dim, enc_layers=n_enc,
        enc_heads=e_heads,
        enc_hidden=A("encoder.encoder.layer.0.intermediate.dense"
                     ".weight").shape[0],
        n_prefix=n_prefix,
        enc_eps=float(enc_cfg.get("layer_norm_eps", 1e-12)),
        vocab_size=vocab, d_model=d_model, dec_layers=n_dec,
        dec_heads=d_heads, dec_ffn=ffn,
        max_len=min(max_len, dec_pos.shape[0] - 2),
        scale_embedding=bool(dec_cfg.get("scale_embedding", False)),
        layernorm_embedding=ln_emb,
        dec_eps=float(dec_cfg.get("layer_norm_eps", 1e-5)),
        act=str(dec_cfg.get("activation_function", "gelu")),
        decoder_start_id=int(next(
            v for v in (config.get("decoder_start_token_id"),
                        dec_cfg.get("decoder_start_token_id"),
                        dec_cfg.get("eos_token_id"), 2)
            if v is not None)),
        eos_id=int(dec_cfg.get("eos_token_id", 2)),
        pad_id=int(dec_cfg.get("pad_token_id", 1)),
    )
    if in_ch != 3:
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"expected 3-channel patch conv, got {in_ch}")

    prefix = [A("encoder.embeddings.cls_token")[0, 0]]
    if has_dist:
        prefix.append(A("encoder.embeddings.distillation_token")[0, 0])
    enc = {
        "patch_w": pw.reshape(enc_dim, -1).T,
        "patch_b": A("encoder.embeddings.patch_embeddings.projection.bias"),
        "prefix": np.stack(prefix),
        "pos": pos,
        "ln_g": A("encoder.layernorm.weight"),
        "ln_b": A("encoder.layernorm.bias"),
        "layers": _vit_stack(A, "encoder.encoder.layer", n_enc),
    }

    DL: Dict[str, list] = {}
    dpre = "decoder.model.decoder.layers"
    for ours, theirs in (("wq", "self_attn.q_proj"),
                         ("wk", "self_attn.k_proj"),
                         ("wv", "self_attn.v_proj"),
                         ("wo", "self_attn.out_proj"),
                         ("cq", "encoder_attn.q_proj"),
                         ("ck", "encoder_attn.k_proj"),
                         ("cv", "encoder_attn.v_proj"),
                         ("co", "encoder_attn.out_proj"),
                         ("w1", "fc1"), ("w2", "fc2")):
        DL[ours] = [A(f"{dpre}.{i}.{theirs}.weight").T for i in range(n_dec)]
        bias = "b" + ours[1:] if ours[0] == "w" else "cb" + ours[1:]
        DL[bias] = [A(f"{dpre}.{i}.{theirs}.bias") for i in range(n_dec)]
    for ours, theirs in (("ln_sa", "self_attn_layer_norm"),
                         ("ln_ca", "encoder_attn_layer_norm"),
                         ("ln_f", "final_layer_norm")):
        DL[f"{ours}_g"] = [A(f"{dpre}.{i}.{theirs}.weight")
                           for i in range(n_dec)]
        DL[f"{ours}_b"] = [A(f"{dpre}.{i}.{theirs}.bias")
                           for i in range(n_dec)]
    dec = {
        "embed": emb,
        "pos": dec_pos,
        "out_w": A("decoder.output_projection.weight"),
        "layers": DL,
    }
    if ln_emb:
        dec["ln_emb_g"] = A("decoder.model.decoder.layernorm_embedding"
                            ".weight")
        dec["ln_emb_b"] = A("decoder.model.decoder.layernorm_embedding"
                            ".bias")
    return _vision_tree({"enc": enc, "dec": dec}, dtype, device), cfg


def ast_from_hf(state: Dict[str, Any],
                config: Optional[Dict[str, Any]] = None, *,
                n_heads: int = 0, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None):
    """HF ``ASTForAudioClassification`` (MIT/ast-finetuned-audioset-*)
    state dict -> (params, ASTConfig, labels) for models/ast.py, on
    ``device`` (the CUDA card by default).

    Geometry is shape-derived where possible (dim, patch, layer count,
    label count); the strides and input frame/mel extents come from
    ``config`` (the HF config dict: not derivable from weights alone; the
    position embeddings' length cross-checks them). ``labels`` is the
    ordered id2label list (empty when the config carries none)."""
    from trackiellm_tpu_torch.models.ast import ASTConfig

    device = default_device(device, "convert")
    config = config or {}
    pre = "audio_spectrogram_transformer"
    A = _strict(state)

    pw = A(f"{pre}.embeddings.patch_embeddings.projection.weight")
    dim, in_ch, patch, _ = pw.shape
    if in_ch != 1:
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           f"expected 1-channel patch conv, got {in_ch}")
    n_layers = len({k.split(".")[3] for k in state
                    if k.startswith(f"{pre}.encoder.layer.")})
    head_w = A("classifier.dense.weight")
    n_labels = head_w.shape[0]
    pos = A(f"{pre}.embeddings.position_embeddings")[0]

    cfg = ASTConfig(
        n_mels=int(config.get("num_mel_bins", 128)),
        n_frames=int(config.get("max_length", 1024)),
        patch=patch,
        fstride=int(config.get("frequency_stride", 10)),
        tstride=int(config.get("time_stride", 10)),
        dim=dim, n_layers=n_layers,
        n_heads=n_heads or int(config.get("num_attention_heads")
                               or {192: 3, 384: 6, 768: 12}.get(dim, 12)),
        hidden=A(f"{pre}.encoder.layer.0.intermediate.dense.weight"
                 ).shape[0],
        eps=float(config.get("layer_norm_eps", 1e-12)),
        n_labels=n_labels)
    if pos.shape[0] != cfg.n_patches + 2:
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"position embeddings carry {pos.shape[0]} tokens but the "
            f"config geometry gives {cfg.n_patches}+2: check "
            f"num_mel_bins/max_length/strides")

    tree = {
        "patch_w": pw,
        "patch_b": A(f"{pre}.embeddings.patch_embeddings.projection.bias"),
        "prefix": np.stack([A(f"{pre}.embeddings.cls_token")[0, 0],
                            A(f"{pre}.embeddings.distillation_token")[0, 0]]),
        "pos": pos,
        "ln_g": A(f"{pre}.layernorm.weight"),
        "ln_b": A(f"{pre}.layernorm.bias"),
        "head_ln_g": A("classifier.layernorm.weight"),
        "head_ln_b": A("classifier.layernorm.bias"),
        "head_w": head_w.T,
        "head_b": A("classifier.dense.bias"),
        "layers": _vit_stack(A, f"{pre}.encoder.layer", n_layers),
    }
    id2label = config.get("id2label") or {}
    labels = [str(id2label.get(str(i), id2label.get(i, "")))
              for i in range(n_labels)] if id2label else []
    return _vision_tree(tree, dtype, device), cfg, labels


def sound_classifier_from_torch(state: Dict[str, Any], n_mels: int = 64,
                                n_frames: int = 96,
                                device: Optional[torch.device] = None):
    """Conv+pool classifier checkpoint -> (params, SoundClassifierConfig)
    for models/sound_classifier, OIHW convolutions on ``device`` (the CUDA
    card by default). Parity: the reference's ONNX ambient classifier
    (src/audio/tk_sound_classifier.c:14)."""
    from trackiellm_tpu_torch.models.sound_classifier import (
        SoundClassifierConfig)

    device = default_device(device, "convert")
    ch = int(np.shape(state["conv2.weight"])[0])
    ncls = int(np.shape(state["out.weight"])[0])
    params = {
        "conv1": _plain_conv(state, "conv1", device),
        "conv2": _plain_conv(state, "conv2", device),
        "conv3": _plain_conv(state, "conv3", device),
        "out_w": _on(_f32(state["out.weight"]).T, device),
        "out_b": _on(state["out.bias"], device),
    }
    cfg = SoundClassifierConfig(n_mels=n_mels, n_frames=n_frames, ch=ch,
                                num_classes=ncls)
    return params, cfg


# ---------------------------------------------------------------------------
# transformers state dicts of the LLM families (``convert --family *-hf``)
# ---------------------------------------------------------------------------
#
# Each reads host numpy in f32 as the JAX package's converter of the same
# name does and gives its tree on ``device`` in ``dtype`` (bf16 rounds to
# nearest even, as ``jnp.asarray(a, bf16)``); the leaves the reference keeps
# in f32 stay f32. The CLI requantizes afterwards (``llm.quantize_params``
# at ``--bits``). Head counts and other fields that are not
# shape-derivable come from the keyword defaults, as in the reference.

def _hf_common(state: Dict[str, Any], prefix: str = "model."):
    """(A, emb, vocab, dim, n_layers) of a Llama-named state dict."""
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    emb = A(prefix + "embed_tokens.weight")
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith(prefix + "layers.")})
    return A, emb, emb.shape[0], emb.shape[1], n_layers


def _hf_head(state: Dict[str, Any], A, emb: np.ndarray) -> np.ndarray:
    return (A("lm_head.weight").T if "lm_head.weight" in state
            else np.ascontiguousarray(emb.T))


def _hf_tree(L: Dict[str, list], emb: np.ndarray, out_norm, lm_head,
             dtype: torch.dtype, device: Optional[torch.device],
             f32_keys=(), out_norm_dtype: Optional[torch.dtype] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The LLM tree on ``device``: each non-empty list of ``L`` stacked (a
    list of {"g", "b"} dicts per key), in ``dtype`` or f32 for
    ``f32_keys``; ``out_norm`` (an array or a {"g", "b"} dict) in
    ``out_norm_dtype`` (default ``dtype``); ``extra`` top-level tensors as
    given (rope factors) moved to the device."""
    device = default_device(device, "convert a checkpoint")
    tensor = _converter_tools(device, None, 0, dtype)[0]

    def stacked(values, dt):
        if isinstance(values[0], dict):
            return {k: tensor(np.stack([v[k] for v in values]), dt)
                    for k in values[0]}
        return tensor(np.stack(values), dt)

    def put(v, dt):
        return ({k: tensor(a, dt) for k, a in v.items()}
                if isinstance(v, dict) else tensor(v, dt))
    params = {
        "tok_emb": tensor(emb, dtype),
        "layers": {k: stacked(v, torch.float32 if k in f32_keys else dtype)
                   for k, v in L.items() if v},
        "out_norm": put(out_norm, out_norm_dtype or dtype),
        "lm_head": tensor(lm_head, dtype),
    }
    for k, v in (extra or {}).items():
        params[k] = v.to(device)
    return params


def _qkv_T(A, pre: str, deint=None, n_heads: int = 0, n_kv: int = 0):
    """[q | k | v] of ``pre``.self_attn as one (D, Q + 2 KV) matrix; with
    ``deint``, q's and k's interleaved rope columns folded to split-half."""
    q, k, v = (A(f"{pre}.self_attn.{p}_proj.weight").T for p in "qkv")
    if deint is not None:
        q, k = deint(q, n_heads), deint(k, n_kv)
    return np.concatenate([q, k, v], axis=1)


def _qkv_bias(A, pre: str, deint=None, n_heads: int = 0, n_kv: int = 0):
    q, k, v = (A(f"{pre}.self_attn.{p}_proj.bias") for p in "qkv")
    if deint is not None:
        q, k = deint(q, n_heads), deint(k, n_kv)
    return np.concatenate([q, k, v])


def _gu_T(A, pre: str) -> np.ndarray:
    """[gate | up] of an MLP named ``pre``.{gate,up}_proj, (D, 2H)."""
    return np.concatenate([A(f"{pre}.gate_proj.weight").T,
                           A(f"{pre}.up_proj.weight").T], axis=1)


def _experts(A, pre: str, n: int):
    """(E, D, 2H) [gate | up] and (E, H, D) down banks of ``pre``.N."""
    return (np.stack([_gu_T(A, f"{pre}.{e}") for e in range(n)]),
            np.stack([A(f"{pre}.{e}.down_proj.weight").T for e in range(n)]))


def _n_experts(state: Dict[str, Any], prefix: str) -> int:
    return len({k.split(".")[5] for k in state if k.startswith(prefix)})


def phi3_from_hf(state: Dict[str, Any], *, max_seq: int = 4096,
                 original_max_seq: int = 0, rope_factors_short=None,
                 rope_factors_long=None, sliding_window: int = 2047,
                 norm_eps: float = 1e-5, rope_theta: float = 10000.0,
                 head_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None) -> tuple:
    """Phi-3 (fused qkv_proj and gate_up_proj, untied lm_head) -> (params,
    LLMConfig). Longrope: the config's short/long factor lists and
    ``original_max_position_embeddings``; the attention factor
    sqrt(1 + log(max / orig) / log(orig)) goes into the config. head_dim
    defaults to 96 at dim 3072, else dim // 32."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    qkv0 = A("model.layers.0.self_attn.qkv_proj.weight")
    qd = A("model.layers.0.self_attn.o_proj.weight").shape[1]
    hidden = A("model.layers.0.mlp.gate_up_proj.weight").shape[0] // 2
    hd = head_dim or (96 if dim == 3072 else dim // 32)
    longrope = rope_factors_long is not None
    att = 1.0
    if original_max_seq and max_seq > original_max_seq:
        att = math.sqrt(1.0 + math.log(max_seq / original_max_seq)
                        / math.log(original_max_seq))
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=qd // hd,
        n_kv_heads=(qkv0.shape[0] - qd) // 2 // hd, head_dim=hd,
        hidden_dim=hidden, norm_eps=norm_eps, rope_theta=rope_theta,
        max_seq=max_seq, sliding_window=sliding_window,
        rope_original_max_seq=original_max_seq if longrope else 0,
        rope_attention_factor=att if longrope else 1.0)
    L: Dict[str, list] = {k: [] for k in ("attn_norm", "wqkv", "wo",
                                          "mlp_norm", "w_gu", "w_down")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(A(f"{pre}.self_attn.qkv_proj.weight").T)
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(A(f"{pre}.mlp.gate_up_proj.weight").T)
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    extra = {}
    if longrope:
        extra = {"rope_factors_short": torch.as_tensor(
                     np.asarray(rope_factors_short, np.float32)),
                 "rope_factors_long": torch.as_tensor(
                     np.asarray(rope_factors_long, np.float32))}
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device, extra=extra), cfg


def mixtral_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                    norm_eps: float = 1e-5, rope_theta: float = 1e6,
                    head_dim: int = 0, n_experts_used: int = 2,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> tuple:
    """Mixtral (block_sparse_moe: gate + experts.N.{w1,w2,w3}) -> (params,
    LLMConfig): w1 gate and w3 up fuse into the expert w_gu bank, w2 is
    down, the router transposes to (D, E). head_dim 128 where it divides
    dim, else dim // 32."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    hidden = A("model.layers.0.block_sparse_moe.experts.0.w1.weight"
               ).shape[0]
    n_experts = len({k.split(".")[5] for k in state
                     if ".block_sparse_moe.experts." in k})
    hd = head_dim or (128 if dim % 128 == 0 else dim // 32)
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=q0.shape[0] // hd, n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=hidden, norm_eps=norm_eps, rope_theta=rope_theta,
        max_seq=max_seq, sliding_window=max_seq, n_experts=n_experts,
        n_experts_used=n_experts_used)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "mlp_norm", "moe_gate", "w_gu", "w_down")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        moe = f"{pre}.block_sparse_moe"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["moe_gate"].append(A(f"{moe}.gate.weight").T)
        L["w_gu"].append(np.stack([np.concatenate(
            [A(f"{moe}.experts.{e}.w1.weight").T,
             A(f"{moe}.experts.{e}.w3.weight").T], axis=1)
            for e in range(n_experts)]))
        L["w_down"].append(np.stack([A(f"{moe}.experts.{e}.w2.weight").T
                                     for e in range(n_experts)]))
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def _gemma_norms(A, pre: str, L: Dict[str, list], qk: bool) -> None:
    """A Gemma-2/3 layer's sandwich norms (and Gemma-3's q/k norms), each
    with the (1 + w) fold."""
    L["attn_norm"].append(A(f"{pre}.input_layernorm.weight") + 1.0)
    L["attn_post_norm"].append(
        A(f"{pre}.post_attention_layernorm.weight") + 1.0)
    L["mlp_norm"].append(A(f"{pre}.pre_feedforward_layernorm.weight") + 1.0)
    L["mlp_post_norm"].append(
        A(f"{pre}.post_feedforward_layernorm.weight") + 1.0)
    if qk:
        L["q_norm"].append(A(f"{pre}.self_attn.q_norm.weight") + 1.0)
        L["k_norm"].append(A(f"{pre}.self_attn.k_norm.weight") + 1.0)


def _gemma_tree(state, A, emb, dim: int, n_layers: int, qk: bool,
                dtype, device, extra=None) -> Dict[str, Any]:
    keys = ["attn_norm", "wqkv", "wo", "mlp_norm", "w_gu", "w_down",
            "attn_post_norm", "mlp_post_norm"]
    L: Dict[str, list] = {k: [] for k in keys + (["q_norm", "k_norm"]
                                                 if qk else [])}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        _gemma_norms(A, pre, L, qk)
        L["wqkv"].append(_qkv_T(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(_gu_T(A, f"{pre}.mlp"))
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    return _hf_tree(L, emb * float(np.sqrt(dim)),
                    A("model.norm.weight") + 1.0, _hf_head(state, A, emb),
                    dtype, device, extra=extra)


def gemma2_from_hf(state: Dict[str, Any], *, head_dim: int = 0,
                   max_seq: int = 8192, sliding_window: int = 4096,
                   attn_softcap: float = 50.0, logit_softcap: float = 30.0,
                   query_pre_attn_scalar: float = 0.0,
                   norm_eps: float = 1e-6, rope_theta: float = 10000.0,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> tuple:
    """Gemma-2 -> (params, LLMConfig): every RMSNorm weight stored as
    (1 + w), tok_emb scaled by sqrt(dim) (the tied lm_head keeps the
    unscaled copy), alternating windows, both softcaps. ``head_dim`` and
    ``query_pre_attn_scalar`` of 0 resolve from the published sizes: 256
    and 256 below dim 4608, else 128 and dim / n_heads."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    hd = head_dim or (128 if dim >= 4608 else 256)
    n_heads = q0.shape[0] // hd
    if not query_pre_attn_scalar:
        query_pre_attn_scalar = float(hd if dim < 4608 else dim // n_heads)
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=sliding_window, act="gelu", post_norms=True,
        attn_softcap=attn_softcap, logit_softcap=logit_softcap,
        query_pre_attn_scalar=query_pre_attn_scalar, alt_window=True)
    return _gemma_tree(state, A, emb, dim, n_layers, False, dtype,
                       device), cfg


def gemma3_from_hf(state: Dict[str, Any], *, head_dim: int = 0,
                   max_seq: int = 32768, sliding_window: int = 512,
                   window_pattern: int = 6,
                   query_pre_attn_scalar: float = 256.0,
                   norm_eps: float = 1e-6, rope_theta: float = 1e6,
                   rope_local_theta: float = 10000.0,
                   rope_linear_factor: float = 0.0,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> tuple:
    """Gemma-3 text -> (params, LLMConfig): Gemma-2's folds, per-head Q/K
    norms ((1 + w) too) instead of the softcaps, a 5:1 sliding/global
    pattern and the dual rope (local 10k, global ``rope_theta`` with the
    optional linear factor). head_dim from q_norm."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = head_dim or A("model.layers.0.self_attn.q_norm.weight").shape[0]
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd,
        head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=sliding_window, act="gelu", post_norms=True,
        query_pre_attn_scalar=query_pre_attn_scalar, qk_norm=True,
        window_pattern=window_pattern, rope_local_theta=rope_local_theta)
    extra = ({"rope_factors": llm_model.linear_rope_factors(
        cfg, rope_linear_factor)} if rope_linear_factor > 1.0 else None)
    return _gemma_tree(state, A, emb, dim, n_layers, True, dtype, device,
                       extra), cfg


def wake_word_from_torch(state: Dict[str, Any], n_mels: int = 40,
                         n_frames: int = 76, sensitivity: float = 0.5,
                         device: Optional[torch.device] = None):
    """A conv keyword-spotter checkpoint (conv1, conv2, out) -> (params,
    WakeWordConfig) of ``audio/wake_word.py``: convolutions OIHW as torch
    stores them, the head (in, out), f32 on ``device``."""
    from trackiellm_tpu_torch.audio.wake_word import WakeWordConfig

    device = default_device(device, "convert a checkpoint")

    def f32(k):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(state[k], np.float32))).to(device)
    params = {f"conv{i}": {"w": f32(f"conv{i}.weight"),
                           "b": f32(f"conv{i}.bias")} for i in (1, 2)}
    params["out_w"] = f32("out.weight").t().contiguous()
    params["out_b"] = f32("out.bias")
    ch = int(np.asarray(state["conv2.weight"]).shape[0])
    return params, WakeWordConfig(n_mels=n_mels, n_frames=n_frames, ch=ch,
                                  sensitivity=sensitivity)


def qwen2_moe_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                      norm_eps: float = 1e-6, rope_theta: float = 1e6,
                      head_dim: int = 0, n_experts_used: int = 4,
                      norm_topk: bool = False,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[torch.device] = None) -> tuple:
    """Qwen2-MoE -> (params, LLMConfig): Qwen2 attention (QKV biases),
    top-k routed experts (``mlp.experts.N``) and an always-active shared
    expert gated by sigmoid(``mlp.shared_expert_gate``); the top-k weights
    are not renormalized unless ``norm_topk``."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    n_experts = len({k.split(".")[5] for k in state if ".mlp.experts." in k})
    hd = head_dim or (128 if q0.shape[0] % 128 == 0 else dim // 16)
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=q0.shape[0] // hd, n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.experts.0.gate_proj.weight"
                     ).shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, qkv_bias=True, n_experts=n_experts,
        n_experts_used=n_experts_used, moe_norm_topk=norm_topk,
        moe_shared_hidden=A("model.layers.0.mlp.shared_expert.gate_proj"
                            ".weight").shape[0])
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wqkv_bias", "wo", "mlp_norm", "moe_gate",
        "w_gu", "w_down", "shared_gu", "shared_down", "shared_gate")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        L["wqkv_bias"].append(_qkv_bias(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["moe_gate"].append(A(f"{pre}.mlp.gate.weight").T)
        gu, down = _experts(A, f"{pre}.mlp.experts", n_experts)
        L["w_gu"].append(gu)
        L["w_down"].append(down)
        L["shared_gu"].append(_gu_T(A, f"{pre}.mlp.shared_expert"))
        L["shared_down"].append(
            A(f"{pre}.mlp.shared_expert.down_proj.weight").T)
        L["shared_gate"].append(A(f"{pre}.mlp.shared_expert_gate.weight").T)
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def olmo2_from_hf(state: Dict[str, Any], *, max_seq: int = 4096,
                  norm_eps: float = 1e-6, rope_theta: float = 500000.0,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> tuple:
    """OLMo-2 -> (params, LLMConfig): post-norms only (the branches read
    the raw residual; ``pre_norms=False``) and Q/K RMSNorm over the whole
    projection (``qk_norm_full``). head_dim 128 where it divides the q
    rows, else q_rows // 16."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    hd = 128 if q0.shape[0] % 128 == 0 else q0.shape[0] // 16
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=q0.shape[0] // hd, n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, pre_norms=False, post_norms=True,
        qk_norm_full=True)
    L: Dict[str, list] = {k: [] for k in (
        "wqkv", "wo", "w_gu", "w_down", "attn_post_norm", "mlp_post_norm",
        "q_norm", "k_norm")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_post_norm"].append(
            A(f"{pre}.post_attention_layernorm.weight"))
        L["mlp_post_norm"].append(
            A(f"{pre}.post_feedforward_layernorm.weight"))
        L["q_norm"].append(A(f"{pre}.self_attn.q_norm.weight"))
        L["k_norm"].append(A(f"{pre}.self_attn.k_norm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(_gu_T(A, f"{pre}.mlp"))
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def _qwen3_layers(state, A, n_layers: int, n_experts: int) -> Dict[str, list]:
    """Qwen3's layers (QK-norm, no biases), dense or with routed experts."""
    keys = (["attn_norm", "wqkv", "wo", "mlp_norm"]
            + (["moe_gate"] if n_experts else [])
            + ["w_gu", "w_down", "q_norm", "k_norm"])
    L: Dict[str, list] = {k: [] for k in keys}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["q_norm"].append(A(f"{pre}.self_attn.q_norm.weight"))
        L["k_norm"].append(A(f"{pre}.self_attn.k_norm.weight"))
        if n_experts:
            L["moe_gate"].append(A(f"{pre}.mlp.gate.weight").T)
            gu, down = _experts(A, f"{pre}.mlp.experts", n_experts)
        else:
            gu, down = (_gu_T(A, f"{pre}.mlp"),
                        A(f"{pre}.mlp.down_proj.weight").T)
        L["w_gu"].append(gu)
        L["w_down"].append(down)
    return L


def qwen3_from_hf(state: Dict[str, Any], *, max_seq: int = 32768,
                  norm_eps: float = 1e-6, rope_theta: float = 1e6,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> tuple:
    """Qwen3 (dense) -> (params, LLMConfig): per-head Q/K RMSNorm before
    rope instead of Qwen2's QKV biases; head_dim from q_norm."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = A("model.layers.0.self_attn.q_norm.weight").shape[0]
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd,
        head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, qk_norm=True)
    return _hf_tree(_qwen3_layers(state, A, n_layers, 0), emb,
                    A("model.norm.weight"), _hf_head(state, A, emb), dtype,
                    device), cfg


def qwen3_moe_from_hf(state: Dict[str, Any], *, max_seq: int = 32768,
                      norm_eps: float = 1e-6, rope_theta: float = 1e6,
                      n_experts_used: int = 8, norm_topk: bool = True,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[torch.device] = None) -> tuple:
    """Qwen3-MoE -> (params, LLMConfig): Qwen3 attention, top-k routed
    experts renormalized (``norm_topk``), no shared expert."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = A("model.layers.0.self_attn.q_norm.weight").shape[0]
    n_experts = len({k.split(".")[5] for k in state if ".mlp.experts." in k})
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd,
        head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.experts.0.gate_proj.weight"
                     ).shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, qk_norm=True, n_experts=n_experts,
        n_experts_used=n_experts_used, moe_norm_topk=norm_topk)
    return _hf_tree(_qwen3_layers(state, A, n_layers, n_experts), emb,
                    A("model.norm.weight"), _hf_head(state, A, emb), dtype,
                    device), cfg


def gpt_oss_from_hf(state: Dict[str, Any], *, head_dim: int = 64,
                    max_seq: int = 131072, sliding_window: int = 128,
                    norm_eps: float = 1e-5, rope_theta: float = 150000.0,
                    n_experts_used: int = 4,
                    rope_scaling_factor: float = 32.0,
                    rope_original_max_seq: int = 4096,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> tuple:
    """gpt-oss -> (params, LLMConfig): attention sinks (kept f32), biases
    on all four attention projections, expert banks already (E, D, 2I)
    with gate/up interleaved (even columns gate, odd up: split into [gate
    | up] here), the router with its bias and softmax after the top-k,
    and non-truncated YaRN (``rope_scaling_factor=0`` for none) as
    ``rope_factors`` and the attention factor."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    n_experts, _, two_h = A("model.layers.0.mlp.experts.gate_up_proj").shape
    attn_factor = (llm_model.yarn_attention_factor(rope_scaling_factor)
                   if rope_scaling_factor > 1.0 else 1.0)
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0]
        // head_dim,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0]
        // head_dim,
        head_dim=head_dim, hidden_dim=two_h // 2, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=sliding_window, alt_window=True,
        n_experts=n_experts, n_experts_used=n_experts_used,
        moe_score_func="softmax_topk", moe_norm_topk=False,
        moe_bias=True, attn_sinks=True, qkv_bias=True, out_bias=True,
        act="gptoss", rope_attention_factor=attn_factor)

    def split(gu):  # (..., 2I) even = gate / odd = up -> [gate | up]
        return np.concatenate([gu[..., 0::2], gu[..., 1::2]], axis=-1)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wqkv_bias", "wo", "wo_bias", "attn_sink",
        "mlp_norm", "moe_gate", "moe_gate_b", "w_gu", "w_gu_b", "w_down",
        "w_down_b")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        ex = f"{pre}.mlp.experts"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        L["wqkv_bias"].append(_qkv_bias(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["wo_bias"].append(A(f"{pre}.self_attn.o_proj.bias"))
        L["attn_sink"].append(A(f"{pre}.self_attn.sinks"))
        L["moe_gate"].append(A(f"{pre}.mlp.router.weight").T)
        L["moe_gate_b"].append(A(f"{pre}.mlp.router.bias"))
        L["w_gu"].append(split(A(f"{ex}.gate_up_proj")))
        L["w_gu_b"].append(split(A(f"{ex}.gate_up_proj_bias")))
        L["w_down"].append(A(f"{ex}.down_proj"))
        L["w_down_b"].append(A(f"{ex}.down_proj_bias"))
    extra = None
    if rope_scaling_factor > 1.0:
        extra = {"rope_factors": llm_model.yarn_rope_factors(
            cfg, rope_scaling_factor, rope_original_max_seq,
            truncate=False)}
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device, f32_keys=("attn_sink",),
                    extra=extra), cfg


def _llama_layers(A, n_layers: int, deint=None, n_heads: int = 0,
                  n_kv: int = 0) -> Dict[str, list]:
    """The Llama template's layers (RMSNorms, [q|k|v], SwiGLU), q's and
    k's rope columns folded by ``deint`` where given."""
    L: Dict[str, list] = {k: [] for k in ("attn_norm", "wqkv", "wo",
                                          "mlp_norm", "w_gu", "w_down")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre, deint, n_heads, n_kv))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(_gu_T(A, f"{pre}.mlp"))
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    return L


def granite_from_hf(state: Dict[str, Any], *,
                    embedding_multiplier: float = 12.0,
                    residual_multiplier: float = 0.22,
                    attention_multiplier: float = 0.0078125,
                    logits_scaling: float = 16.0, max_seq: int = 8192,
                    norm_eps: float = 1e-5, rope_theta: float = 1e7,
                    head_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> tuple:
    """Granite -> (params, LLMConfig): the Llama template with four muP
    multipliers; the embedding multiplier scales tok_emb (the tied head
    keeps the unscaled copy), logits_scaling divides lm_head, the attention
    multiplier becomes query_pre_attn_scalar = m**-2, and the residual
    multiplier runs. head_dim: the first of 128, 64, 8 that divides."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    hd = head_dim
    if not hd:
        for hd in (128, 64, 8):
            if q0.shape[0] % hd == 0 and k0.shape[0] % hd == 0 \
                    and dim % hd == 0:
                break
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=q0.shape[0] // hd, n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, residual_multiplier=residual_multiplier,
        query_pre_attn_scalar=float(attention_multiplier ** -2))
    return _hf_tree(_llama_layers(A, n_layers), emb * embedding_multiplier,
                    A("model.norm.weight"),
                    _hf_head(state, A, emb) / logits_scaling, dtype,
                    device), cfg


def glm4_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                 norm_eps: float = 1e-5, rope_theta: float = 10000.0,
                 partial_rotary_factor: float = 0.5, head_dim: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None) -> tuple:
    """GLM-4 -> (params, LLMConfig): QKV biases, sandwich norms
    (post_self_attn / post_mlp; HF's post_attention_layernorm is the
    pre-MLP norm), fused gate_up, and the half-width interleaved rope
    folded to split-half (``_deinterleave_rope_cols``)."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = head_dim or 128
    n_heads = A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd
    n_kv = A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd
    rotary = int(hd * partial_rotary_factor)
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_up_proj.weight").shape[0] // 2,
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, qkv_bias=qkv_bias, post_norms=True,
        partial_rotary_factor=partial_rotary_factor)

    def deint(w, heads):
        return _deinterleave_rope_cols(w, heads, hd, rotary)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "mlp_norm", "w_gu", "w_down",
        "attn_post_norm", "mlp_post_norm", "wqkv_bias")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["attn_post_norm"].append(
            A(f"{pre}.post_self_attn_layernorm.weight"))
        L["mlp_post_norm"].append(A(f"{pre}.post_mlp_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre, deint, n_heads, n_kv))
        if qkv_bias:
            L["wqkv_bias"].append(_qkv_bias(A, pre, deint, n_heads, n_kv))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(A(f"{pre}.mlp.gate_up_proj.weight").T)
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def llama4_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                   norm_eps: float = 1e-5, rope_theta: float = 500000.0,
                   nope_pattern: int = 4, attn_chunk: int = 8192,
                   attn_temp_tuning: bool = True,
                   attn_temp_floor: float = 8192.0,
                   attn_temp_scale: float = 0.1, qk_l2norm: bool = True,
                   head_dim: int = 0,
                   rope_scaling: Optional[Dict[str, Any]] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> tuple:
    """Llama-4 text -> (params, LLMConfig): sigmoid top-1 routing scaling
    the expert input, an ungated shared expert, the interleaved full-width
    rope folded to split-half; Maverick's dense/MoE interleave carries
    both MLP stacks (zeros where a layer does not use one,
    ``moe_pattern``). ``rope_scaling``: the config's llama3-style dict."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    is_moe = [f"model.layers.{i}.feed_forward.experts.gate_up_proj"
              in state for i in range(n_layers)]
    if not any(is_moe):
        raise NotImplementedError(
            "all-dense Llama-4 checkpoints are not a published shape")
    moe_pattern = 0
    if not all(is_moe):
        step = is_moe.index(True) + 1
        if [(i % step) == (step - 1) for i in range(n_layers)] != is_moe:
            raise NotImplementedError(
                f"irregular dense/MoE layout {is_moe} — only the "
                f"interleave_moe_layer_step pattern is supported")
        moe_pattern = step
    first = f"model.layers.{is_moe.index(True)}.feed_forward"
    n_experts, _, two_h = np.asarray(
        state[f"{first}.experts.gate_up_proj"]).shape
    hidden = two_h // 2
    shared_h = A(f"{first}.shared_expert.gate_proj.weight").shape[0]
    hidden_mlp = (int(A("model.layers.0.feed_forward.gate_proj.weight"
                        ).shape[0]) if moe_pattern else 0)
    hd = head_dim or 128
    n_heads, n_kv = q0.shape[0] // hd, k0.shape[0] // hd
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd, hidden_dim=hidden, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq, sliding_window=max_seq,
        n_experts=n_experts, n_experts_used=1,
        moe_score_func="sigmoid_topk", moe_norm_topk=False,
        moe_scale_input=True, moe_shared_hidden=shared_h,
        moe_shared_gated=False, nope_pattern=nope_pattern,
        qk_l2norm=qk_l2norm, attn_temp_tuning=attn_temp_tuning,
        attn_temp_floor=attn_temp_floor, attn_temp_scale=attn_temp_scale,
        attn_chunk=attn_chunk, moe_pattern=moe_pattern)

    def deint(w, heads):
        return _deinterleave_rope_cols(w, heads, hd, hd)
    L = _llama_layers(A, 0)
    L.update({k: [] for k in ("moe_gate", "shared_gu", "shared_down",
                              "w_gu_mlp", "w_down_mlp")})
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        ff = f"{pre}.feed_forward"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre, deint, n_heads, n_kv))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        if is_moe[i]:
            L["w_gu"].append(A(f"{ff}.experts.gate_up_proj"))
            L["w_down"].append(A(f"{ff}.experts.down_proj"))
            L["moe_gate"].append(A(f"{ff}.router.weight").T)
            L["shared_gu"].append(_gu_T(A, f"{ff}.shared_expert"))
            L["shared_down"].append(
                A(f"{ff}.shared_expert.down_proj.weight").T)
            if moe_pattern:
                L["w_gu_mlp"].append(zeros(dim, 2 * hidden_mlp))
                L["w_down_mlp"].append(zeros(hidden_mlp, dim))
        else:
            L["w_gu"].append(zeros(n_experts, dim, 2 * hidden))
            L["w_down"].append(zeros(n_experts, hidden, dim))
            L["moe_gate"].append(zeros(dim, n_experts))
            L["shared_gu"].append(zeros(dim, 2 * shared_h))
            L["shared_down"].append(zeros(shared_h, dim))
            L["w_gu_mlp"].append(_gu_T(A, ff))
            L["w_down_mlp"].append(A(f"{ff}.down_proj.weight").T)
    extra = None
    if rope_scaling and rope_scaling.get(
            "rope_type", rope_scaling.get("type")) == "llama3":
        extra = {"rope_factors": llm_model.llama3_rope_factors(
            cfg, factor=float(rope_scaling.get("factor", 8.0)),
            low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rope_scaling.get("high_freq_factor",
                                                    4.0)),
            original_max_seq=int(rope_scaling.get(
                "original_max_position_embeddings", 8192)))}
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device, extra=extra), cfg


def _ln_stack(A, n_layers: int, names, plus_one: bool = False):
    """Per-layer {"g", "b"} LayerNorm dicts of ``names`` (a key -> HF norm
    name map), g + 1 under ``plus_one`` (LayerNorm1p)."""
    out = {k: [] for k in names}
    for i in range(n_layers):
        for key, hf in names.items():
            pre = f"model.layers.{i}.{hf}"
            out[key].append({"g": A(f"{pre}.weight") + (1.0 if plus_one
                                                         else 0.0),
                             "b": A(f"{pre}.bias")})
    return out


def nemotron_from_hf(state: Dict[str, Any], *, max_seq: int = 4096,
                     norm_eps: float = 1e-5, rope_theta: float = 10000.0,
                     partial_rotary_factor: float = 0.5, head_dim: int = 0,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> tuple:
    """Nemotron -> (params, LLMConfig): LayerNorm1p norms with biases (the
    +1 folded, f32), an ungated squared-ReLU MLP, half-width split-half
    rope. head_dim: the first of 128, 64, 16 that divides."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    q0 = A("model.layers.0.self_attn.q_proj.weight")
    k0 = A("model.layers.0.self_attn.k_proj.weight")
    hd = head_dim
    if not hd:
        for hd in (128, 64, 16):
            if q0.shape[0] % hd == 0 and k0.shape[0] % hd == 0:
                break
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=q0.shape[0] // hd, n_kv_heads=k0.shape[0] // hd, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.up_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, norm_type="layernorm", mlp_gated=False,
        act="relu2", partial_rotary_factor=partial_rotary_factor)
    L: Dict[str, list] = {k: [] for k in ("wqkv", "wo", "w_gu", "w_down")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["wqkv"].append(_qkv_T(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(A(f"{pre}.mlp.up_proj.weight").T)
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
    L.update(_ln_stack(A, n_layers, {"attn_norm": "input_layernorm",
                                     "mlp_norm": "post_attention_layernorm"},
                       plus_one=True))
    return _hf_tree(L, emb, {"g": 1.0 + A("model.norm.weight"),
                             "b": A("model.norm.bias")},
                    _hf_head(state, A, emb), dtype, device,
                    f32_keys=("attn_norm", "mlp_norm"),
                    out_norm_dtype=torch.float32), cfg


def starcoder2_from_hf(state: Dict[str, Any], *, max_seq: int = 4096,
                       norm_eps: float = 1e-5, rope_theta: float = 1e5,
                       head_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                       device: Optional[torch.device] = None) -> tuple:
    """StarCoder2 -> (params, LLMConfig): LayerNorms with biases (f32),
    biases on every attention projection and on the ungated tanh-GELU MLP
    (c_fc, c_proj), full rope."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = head_dim or 128
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd,
        head_dim=hd, hidden_dim=A("model.layers.0.mlp.c_fc.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, norm_type="layernorm", mlp_gated=False,
        act="gelu", mlp_bias=True, qkv_bias=True, out_bias=True)
    L: Dict[str, list] = {k: [] for k in (
        "wqkv", "wqkv_bias", "wo", "wo_bias", "w_gu", "w_gu_b", "w_down",
        "w_down_b")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["wqkv"].append(_qkv_T(A, pre))
        L["wqkv_bias"].append(_qkv_bias(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["wo_bias"].append(A(f"{pre}.self_attn.o_proj.bias"))
        L["w_gu"].append(A(f"{pre}.mlp.c_fc.weight").T)
        L["w_gu_b"].append(A(f"{pre}.mlp.c_fc.bias"))
        L["w_down"].append(A(f"{pre}.mlp.c_proj.weight").T)
        L["w_down_b"].append(A(f"{pre}.mlp.c_proj.bias"))
    L.update(_ln_stack(A, n_layers, {"attn_norm": "input_layernorm",
                                     "mlp_norm": "post_attention_layernorm"}))
    return _hf_tree(L, emb, {"g": A("model.norm.weight"),
                             "b": A("model.norm.bias")},
                    _hf_head(state, A, emb), dtype, device,
                    f32_keys=("attn_norm", "mlp_norm"),
                    out_norm_dtype=torch.float32), cfg


def cohere_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                   norm_eps: float = 1e-5, rope_theta: float = 10000.0,
                   logit_scale: float = 1.0, sliding_window: int = 0,
                   sliding_window_pattern: int = 0, head_dim: int = 0,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> tuple:
    """Cohere Command-R / Cohere2 -> (params, LLMConfig): bias-free
    LayerNorm, the parallel residual, logit_scale folded into lm_head, the
    interleaved full-width rope folded to split-half (per-head QK norms
    ride the same permutation), and Cohere2's every-n-th global layer
    (rope only on the sliding ones: window_pattern and nope_pattern)."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = head_dim or 128
    n_heads = A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd
    n_kv = A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd
    qk_norm = "model.layers.0.self_attn.q_norm.weight" in state
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        hidden_dim=A("model.layers.0.mlp.gate_proj.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=(sliding_window or max_seq), norm_type="layernorm",
        parallel_residual=True, qk_norm=qk_norm,
        window_pattern=sliding_window_pattern,
        nope_pattern=sliding_window_pattern)

    def deint(w, heads):
        return _deinterleave_rope_cols(w, heads, hd, hd)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "w_gu", "w_down", "q_norm", "k_norm")}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre, deint, n_heads, n_kv))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        L["w_gu"].append(_gu_T(A, f"{pre}.mlp"))
        L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
        if qk_norm:
            L["q_norm"].append(deint(
                A(f"{pre}.self_attn.q_norm.weight").reshape(-1), n_heads))
            L["k_norm"].append(deint(
                A(f"{pre}.self_attn.k_norm.weight").reshape(-1), n_kv))
    # The parallel-residual body reads no pre-MLP norm; the key stays for
    # the pre_norms helpers, ones in f32 as the reference stores them.
    L["mlp_norm"] = [np.ones((dim,), np.float32)] * n_layers
    return _hf_tree(L, emb, A("model.norm.weight"),
                    _hf_head(state, A, emb) * logit_scale, dtype, device,
                    f32_keys=("mlp_norm",),
                    out_norm_dtype=torch.float32), cfg


def ernie45_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                    norm_eps: float = 1e-5, rope_theta: float = 500000.0,
                    head_dim: int = 0, moe_k: int = 6,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> tuple:
    """ERNIE 4.5 (dense or MoE) -> (params, LLMConfig): the interleaved
    full-width rope folded to split-half, optional projection biases; the
    MoE variant's softmax scores selecting on score +
    e_score_correction_bias (``moe_gate_bias``), renormalized top-k,
    ungated shared experts, and the first moe_layer_start_index layers
    dense at the full width (``moe_first_dense``; an interval > 1 maps to
    ``moe_pattern``)."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    hd = head_dim or 128
    n_heads = A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd
    n_kv = A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state
    is_moe = [f"model.layers.{i}.mlp.gate.weight" in state
              for i in range(n_layers)]
    moe = any(is_moe)

    def deint(w, heads):
        return _deinterleave_rope_cols(w, heads, hd, hd)
    if moe:
        first_dense = is_moe.index(True)
        moe_idx = [i for i, m in enumerate(is_moe) if m]
        interval = moe_idx[1] - moe_idx[0] if len(moe_idx) > 1 else 1
        if [i >= first_dense and ((i + 1) % interval == 0)
                for i in range(n_layers)] != is_moe:
            raise NotImplementedError(f"irregular ERNIE MoE layout {is_moe}")
        e0 = f"model.layers.{first_dense}.mlp.experts"
        n_experts = _n_experts(state, e0 + ".")
        moe_hidden = int(A(f"{e0}.0.gate_proj.weight").shape[0])
        shared = f"model.layers.{first_dense}.mlp.shared_experts"
        shared_hidden = (int(A(f"{shared}.gate_proj.weight").shape[0])
                         if f"{shared}.gate_proj.weight" in state else 0)
        dense_idx = [i for i, m in enumerate(is_moe) if not m]
        hidden_dense = (int(A(f"model.layers.{dense_idx[0]}.mlp"
                              ".gate_proj.weight").shape[0])
                        if dense_idx else 0)
    else:
        n_experts = moe_hidden = shared_hidden = first_dense = 0
        interval = 1
        hidden_dense = int(A("model.layers.0.mlp.gate_proj.weight"
                             ).shape[0])
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        hidden_dim=moe_hidden if moe else hidden_dense, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq, sliding_window=max_seq,
        qkv_bias=qkv_bias, n_experts=n_experts,
        n_experts_used=moe_k if moe else 2, moe_norm_topk=True,
        moe_shared_hidden=shared_hidden, moe_shared_gated=False,
        moe_first_dense=first_dense,
        moe_pattern=interval if interval > 1 else 0)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "mlp_norm", "w_gu", "w_down", "wqkv_bias",
        "moe_gate", "moe_gate_bias", "shared_gu", "shared_down", "w_gu_mlp",
        "w_down_mlp")}
    hybrid = moe and (first_dense or interval > 1)
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre, deint, n_heads, n_kv))
        if qkv_bias:
            L["wqkv_bias"].append(_qkv_bias(A, pre, deint, n_heads, n_kv))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        if not moe:
            L["w_gu"].append(_gu_T(A, f"{pre}.mlp"))
            L["w_down"].append(A(f"{pre}.mlp.down_proj.weight").T)
        elif not is_moe[i]:
            L["w_gu_mlp"].append(_gu_T(A, f"{pre}.mlp"))
            L["w_down_mlp"].append(A(f"{pre}.mlp.down_proj.weight").T)
            L["w_gu"].append(zeros(n_experts, dim, 2 * moe_hidden))
            L["w_down"].append(zeros(n_experts, moe_hidden, dim))
            L["moe_gate"].append(zeros(dim, n_experts))
            L["moe_gate_bias"].append(zeros(n_experts))
            L["shared_gu"].append(zeros(dim, 2 * shared_hidden))
            L["shared_down"].append(zeros(shared_hidden, dim))
        else:
            gu, down = _experts(A, f"{pre}.mlp.experts", n_experts)
            L["w_gu"].append(gu)
            L["w_down"].append(down)
            L["moe_gate"].append(A(f"{pre}.mlp.gate.weight").T)
            L["moe_gate_bias"].append(A(
                f"{pre}.mlp.moe_statics.e_score_correction_bias"
            ).reshape(-1))
            L["shared_gu"].append(_gu_T(A, f"{pre}.mlp.shared_experts"))
            L["shared_down"].append(
                A(f"{pre}.mlp.shared_experts.down_proj.weight").T)
            if hybrid:
                width = hidden_dense or moe_hidden
                L["w_gu_mlp"].append(zeros(dim, 2 * width))
                L["w_down_mlp"].append(zeros(width, dim))
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def glm4_moe_from_hf(state: Dict[str, Any], *, max_seq: int = 8192,
                     norm_eps: float = 1e-5, rope_theta: float = 10000.0,
                     partial_rotary_factor: float = 0.5, moe_k: int = 8,
                     routed_scaling_factor: float = 1.0, n_groups: int = 1,
                     topk_groups: int = 1, norm_topk: bool = True,
                     head_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> tuple:
    """GLM-4.5 / 4.6 (Glm4MoeForCausalLM) -> (params, LLMConfig): per-head
    QK RMSNorm where present, half-width split-half rope, DeepSeek-V3's
    routing (sigmoid scores, the selection-only bias, top-2-sum groups,
    renormalized and scaled top-k, ungated shared experts) and the first
    first_k_dense_replace layers dense."""
    A, emb, vocab, dim, n_layers = _hf_common(state)
    qk_norm = "model.layers.0.self_attn.q_norm.weight" in state
    hd = head_dim or (
        int(A("model.layers.0.self_attn.q_norm.weight").shape[0])
        if qk_norm else 128)
    qkv_bias = "model.layers.0.self_attn.q_proj.bias" in state
    is_moe = [f"model.layers.{i}.mlp.gate.weight" in state
              for i in range(n_layers)]
    if not any(is_moe):
        raise NotImplementedError(
            "all-dense glm4_moe checkpoints are not a published shape "
            "(dense GLM-4 loads through glm4_from_hf)")
    first_dense = is_moe.index(True)
    if is_moe != [i >= first_dense for i in range(n_layers)]:
        raise NotImplementedError(
            f"irregular GLM-4.5 dense/MoE layout {is_moe} — only "
            "first_k_dense_replace is published")
    e0 = f"model.layers.{first_dense}.mlp.experts"
    n_experts = _n_experts(state, e0 + ".")
    moe_hidden = int(A(f"{e0}.0.gate_proj.weight").shape[0])
    shared_h = int(A(f"model.layers.{first_dense}.mlp.shared_experts"
                     ".gate_proj.weight").shape[0])
    hidden_dense = (int(A("model.layers.0.mlp.gate_proj.weight").shape[0])
                    if first_dense else 0)
    if n_experts % max(n_groups, 1):
        raise TrackieError(
            ErrorCode.MODEL_METADATA_INVALID,
            f"n_experts={n_experts} not divisible by n_groups={n_groups}")
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers,
        n_heads=A("model.layers.0.self_attn.q_proj.weight").shape[0] // hd,
        n_kv_heads=A("model.layers.0.self_attn.k_proj.weight").shape[0] // hd,
        head_dim=hd, hidden_dim=moe_hidden, norm_eps=norm_eps,
        rope_theta=rope_theta, max_seq=max_seq, sliding_window=max_seq,
        qkv_bias=qkv_bias, qk_norm=qk_norm,
        partial_rotary_factor=partial_rotary_factor, n_experts=n_experts,
        n_experts_used=moe_k, moe_score_func="sigmoid",
        moe_norm_topk=norm_topk, moe_routed_scale=routed_scaling_factor,
        moe_n_groups=n_groups, moe_topk_groups=topk_groups,
        moe_group_score="top2sum", moe_shared_hidden=shared_h,
        moe_shared_gated=False, moe_first_dense=first_dense)
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "mlp_norm", "w_gu", "w_down", "moe_gate",
        "moe_gate_bias", "shared_gu", "shared_down", "q_norm", "k_norm",
        "wqkv_bias", "w_gu_mlp", "w_down_mlp")}
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        L["attn_norm"].append(A(f"{pre}.input_layernorm.weight"))
        L["mlp_norm"].append(A(f"{pre}.post_attention_layernorm.weight"))
        L["wqkv"].append(_qkv_T(A, pre))
        if qkv_bias:
            L["wqkv_bias"].append(_qkv_bias(A, pre))
        L["wo"].append(A(f"{pre}.self_attn.o_proj.weight").T)
        if qk_norm:
            L["q_norm"].append(A(f"{pre}.self_attn.q_norm.weight"))
            L["k_norm"].append(A(f"{pre}.self_attn.k_norm.weight"))
        if is_moe[i]:
            gu, down = _experts(A, f"{pre}.mlp.experts", n_experts)
            L["w_gu"].append(gu)
            L["w_down"].append(down)
            L["moe_gate"].append(A(f"{pre}.mlp.gate.weight").T)
            L["moe_gate_bias"].append(
                A(f"{pre}.mlp.gate.e_score_correction_bias").reshape(-1))
            L["shared_gu"].append(_gu_T(A, f"{pre}.mlp.shared_experts"))
            L["shared_down"].append(
                A(f"{pre}.mlp.shared_experts.down_proj.weight").T)
            if first_dense:
                L["w_gu_mlp"].append(zeros(dim, 2 * hidden_dense))
                L["w_down_mlp"].append(zeros(hidden_dense, dim))
        else:
            L["w_gu"].append(zeros(n_experts, dim, 2 * moe_hidden))
            L["w_down"].append(zeros(n_experts, moe_hidden, dim))
            L["moe_gate"].append(zeros(dim, n_experts))
            L["moe_gate_bias"].append(zeros(n_experts))
            L["shared_gu"].append(zeros(dim, 2 * shared_h))
            L["shared_down"].append(zeros(shared_h, dim))
            L["w_gu_mlp"].append(_gu_T(A, f"{pre}.mlp"))
            L["w_down_mlp"].append(A(f"{pre}.mlp.down_proj.weight").T)
    return _hf_tree(L, emb, A("model.norm.weight"), _hf_head(state, A, emb),
                    dtype, device), cfg


def falcon_from_hf(state: Dict[str, Any], *, n_heads: int,
                   max_seq: int = 2048, norm_eps: float = 1e-5,
                   rope_theta: float = 1e4, new_arch: Optional[bool] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> tuple:
    """Falcon -> (params, LLMConfig): LayerNorms with biases, the parallel
    residual (the new architecture's second ``ln_mlp``:
    ``parallel_mlp_norm``; ``parallel_attn=False`` checkpoints sequential),
    the fused query_key_value un-fused from its three layouts (multi-query,
    per-head interleaved MHA, per-KV-group new arch) into [q | k | v], and
    the exact-erf GELU MLP. ``new_arch`` auto-detects from ``ln_attn`` and
    the qkv width."""
    A = lambda k: np.asarray(state[k], np.float32)  # noqa: E731
    pre0 = "transformer.h.0."
    emb = A("transformer.word_embeddings.weight")
    vocab, dim = emb.shape
    hd = dim // n_heads
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("transformer.h.")})
    qkv_out = A(pre0 + "self_attention.query_key_value.weight").shape[0]
    two_norm = (pre0 + "ln_attn.weight") in state
    sequential = (pre0 + "post_attention_layernorm.weight") in state
    if new_arch is None:
        new_arch = two_norm or (qkv_out not in (3 * dim, dim + 2 * hd))
    if new_arch:
        n_kv = (qkv_out // hd - n_heads) // 2
    elif qkv_out == dim + 2 * hd:
        n_kv = 1  # multi-query (Falcon-7B)
    else:
        n_kv = n_heads
    qkv_bias = (pre0 + "self_attention.query_key_value.bias") in state
    out_bias = (pre0 + "self_attention.dense.bias") in state
    mlp_bias = (pre0 + "mlp.dense_h_to_4h.bias") in state
    cfg = llm_model.LLMConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=hd,
        hidden_dim=A(pre0 + "mlp.dense_h_to_4h.weight").shape[0],
        norm_eps=norm_eps, rope_theta=rope_theta, max_seq=max_seq,
        sliding_window=max_seq, norm_type="layernorm",
        parallel_residual=not sequential, parallel_mlp_norm=two_norm,
        mlp_gated=False, act="gelu_exact", qkv_bias=qkv_bias,
        out_bias=out_bias, mlp_bias=mlp_bias)

    def unfuse(w: np.ndarray) -> np.ndarray:
        """(qkv_out, D) fused rows (or the bias) -> q|k|v rows."""
        flat = w.reshape(qkv_out, -1)
        if new_arch:
            g = flat.reshape(n_kv, n_heads // n_kv + 2, hd, -1)
            q = g[:, :-2].reshape(n_heads * hd, -1)
            k = g[:, -2].reshape(n_kv * hd, -1)
            v = g[:, -1].reshape(n_kv * hd, -1)
        elif n_kv == 1:
            q, k, v = (flat[:n_heads * hd], flat[n_heads * hd:-hd],
                       flat[-hd:])
        else:
            g = flat.reshape(n_heads, 3, hd, -1)
            q, k, v = (g[:, j].reshape(n_heads * hd, -1) for j in range(3))
        return np.concatenate([q, k, v], axis=0)

    def ln(name):
        return {"g": A(name + ".weight"), "b": A(name + ".bias")}
    L: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wqkv", "wo", "w_gu", "w_down", "mlp_norm", "wqkv_bias",
        "wo_bias", "w_gu_b", "w_down_b")}
    for i in range(n_layers):
        pre = f"transformer.h.{i}."
        if two_norm:
            L["attn_norm"].append(ln(pre + "ln_attn"))
            L["mlp_norm"].append(ln(pre + "ln_mlp"))
        else:
            L["attn_norm"].append(ln(pre + "input_layernorm"))
            if sequential:
                L["mlp_norm"].append(ln(pre + "post_attention_layernorm"))
        L["wqkv"].append(
            unfuse(A(pre + "self_attention.query_key_value.weight")).T)
        L["wo"].append(A(pre + "self_attention.dense.weight").T)
        L["w_gu"].append(A(pre + "mlp.dense_h_to_4h.weight").T)
        L["w_down"].append(A(pre + "mlp.dense_4h_to_h.weight").T)
        if qkv_bias:
            L["wqkv_bias"].append(unfuse(
                A(pre + "self_attention.query_key_value.bias"))[:, 0])
        if out_bias:
            L["wo_bias"].append(A(pre + "self_attention.dense.bias"))
        if mlp_bias:
            L["w_gu_b"].append(A(pre + "mlp.dense_h_to_4h.bias"))
            L["w_down_b"].append(A(pre + "mlp.dense_4h_to_h.bias"))
    return _hf_tree(L, emb, ln("transformer.ln_f"),
                    _hf_head(state, A, emb), dtype, device), cfg


def openwakeword_verifier_from_onnx(state: Dict[str, Any],
                                    device: Optional[torch.device] = None):
    """An openwakeword per-keyword verifier's ONNX initializers ->
    ``audio/wake_word.py:VerifierHead`` on ``device``. The dense chain is
    rebuilt by geometry, not names: each 2-D matrix paired with a bias of
    its output width, oriented (in, out) (an (out, in) export transposed
    where only that orientation chains), ordered backwards from the final
    width 1. An ambiguous or non-chaining inventory raises."""
    from trackiellm_tpu_torch.audio.wake_word import VerifierHead

    mats, biases = [], []
    for k, v in state.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 2:
            mats.append(a)
        elif a.ndim == 1 and a.size > 0:
            biases.append(a)
    if not mats:
        raise TrackieError(ErrorCode.MODEL_METADATA_INVALID,
                           "verifier ONNX carries no 2-D matrices")
    by_width: Dict[int, list] = {}
    for b in biases:
        by_width.setdefault(b.shape[0], []).append(b)

    def orient(a: np.ndarray):
        yield a.shape[0], a.shape[1], a
        if a.shape[0] != a.shape[1]:
            yield a.shape[1], a.shape[0], a.T
    remaining, chain, want_out = list(mats), [], 1
    while remaining:
        matches = [(i, din, w) for i, a in enumerate(remaining)
                   for din, dout, w in orient(a) if dout == want_out]
        if not matches:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"no matrix produces width {want_out}; shapes: "
                f"{[a.shape for a in remaining]}")
        dins = {din for _, din, _ in matches}
        if len(matches) > 1 and len(dins) > 1:
            raise TrackieError(
                ErrorCode.MODEL_METADATA_INVALID,
                f"ambiguous chain at width {want_out}: candidate input "
                f"widths {sorted(dins)}")
        i, din, w = matches[0]
        pool = by_width.get(want_out, [])
        if len(pool) > 1:
            log.warning(
                "openwakeword verifier: %d biases share width %d — "
                "pairing by initializer order; verify against the real "
                "graph on first contact", len(pool), want_out)
        b = pool.pop() if pool else np.zeros(want_out, np.float32)
        chain.append((w, b))
        remaining.pop(i)
        want_out = din
    chain.reverse()
    return VerifierHead(chain, device=default_device(
        device, "build a VerifierHead"))
