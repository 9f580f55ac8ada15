"""Shared transformer layer body for the training forward.

Port of ``trackiellm_tpu/parallel/layers.py``. The JAX package's training,
pipeline and ring forwards share this body (norm -> fused QKV (+bias) ->
rope -> attention -> wo (+ Gemma-2 post-norm) residual -> MLP) and differ in
the attention core and the MLP; here the training forward
(``parallel/train.py``) is its one caller on a single device. The body is
config-aware through the helpers the inference forwards use
(``models/llm.py``: ``_attn_scale``, ``_attn_residual``, ``_mlp``,
``_layer_rope``), so the Gemma-2, Phi-3 and Qwen2 knob sets train.

Exactness contract: with the same params, the training forward matches the
single-device inference forward per row (tests/test_torch_train.py holds it
to the JAX function).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from trackiellm_tpu_torch.models import llm as llm_model

# attn_core(q, k, v, li) -> f32 context (..., S, Hq, Dh); q (..., S, Hq, Dh)
# and k/v (..., S, Hkv, Dh), all roped.
AttnCore = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                    torch.Tensor]
# mlp_fn(x_residual, layer) -> (x_new, aux); None -> the config-aware
# inference MLP (llm_model._mlp) with aux=None.
MlpFn = Optional[Callable[[torch.Tensor, Dict[str, Any]],
                          Tuple[torch.Tensor, Any]]]


def layer_windows(cfg: llm_model.LLMConfig, li: int) -> int:
    """Effective sliding window of layer ``li`` under the config's window
    policy: fixed, or Gemma-2's alternating local (even li) / global (odd
    li). 0 = unbounded."""
    return llm_model._window_of(cfg, li)


def causal_mask(cfg: llm_model.LLMConfig, li: int, q_pos: torch.Tensor,
                k_pos: torch.Tensor) -> torch.Tensor:
    """(Sq, Sk) bool mask from global positions: causal, plus layer
    ``li``'s sliding window (``q - k < window``)."""
    qi = q_pos[:, None]
    ki = k_pos[None, :]
    mask = ki <= qi
    win = layer_windows(cfg, li)
    return mask & (ki > qi - win) if win else mask


def dense_attn_core(cfg: llm_model.LLMConfig, li: int, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Batched softmax attention in f32 torch ops: GQA repeat, the config's
    score scale (query_pre_attn_scalar, longrope/YaRN factor), Gemma-2's
    softcap, per-layer sliding windows. Operands (..., S, H, Dh); returns
    (..., S, Hq, Dh) f32. The reference's is einsum softmax outside Pallas,
    so this is not the flash kernel's work."""
    rep = cfg.n_heads // cfg.n_kv_heads
    kh = k.repeat_interleave(rep, dim=-2) if rep > 1 else k
    vh = v.repeat_interleave(rep, dim=-2) if rep > 1 else v
    scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          kh.float()) * llm_model._attn_scale(cfg)
    if cfg.attn_softcap > 0.0:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = causal_mask(cfg, li, positions, positions)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs, vh.float())


def transformer_layer(x: torch.Tensor, layer: Dict[str, Any], li: int,
                      cfg: llm_model.LLMConfig, tables,
                      positions: torch.Tensor, attn_core: AttnCore,
                      mlp_fn: MlpFn = None) -> Tuple[torch.Tensor, Any]:
    """One config-aware transformer layer on ``x`` (..., S, D), with the
    rope ``tables`` of ``llm_model._rope_tables`` at ``positions`` (S,).

    ``attn_core`` owns the score math; everything else (QKV bias, QK norms,
    rope, Llama-4's post-rope q/k, the wo residual with Gemma-2's sandwich
    norms, the config-aware MLP) is the shared body. Returns ``(x, aux)``
    with ``aux`` the MLP's router stats (None for the default MLP).
    Parallel residuals (Command-R) and chunked attention (Llama-4) are
    refused, as the reference refuses them: they run in inference only."""
    if cfg.parallel_residual:
        raise NotImplementedError(
            "parallel-residual (Command-R) layers are inference-only for "
            "now: the training body keeps sequential residuals")
    if cfg.attn_chunk:
        raise NotImplementedError(
            "chunked attention (Llama-4) is inference-only for now: the "
            "training attention core does not build the chunk mask")
    s = x.shape[-2]
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    lead = x.shape[:-2]

    h = llm_model._attn_in(x, layer, cfg)
    qkv = llm_model._linear(h, layer["wqkv"])
    if cfg.qkv_bias:
        qkv = qkv + layer["wqkv_bias"]
    q = qkv[..., :qd].reshape(*lead, s, cfg.n_heads, cfg.head_dim)
    k = qkv[..., qd:qd + kvd].reshape(*lead, s, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[..., qd + kvd:].reshape(*lead, s, cfg.n_kv_heads, cfg.head_dim)
    q, k = llm_model._qk_norm(q, k, layer, cfg)
    rope = llm_model._layer_rope(cfg, li, tables)
    if rope is not None:
        q, k = llm_model._rotate(q, *rope), llm_model._rotate(k, *rope)
    q, k = llm_model._post_rope_qk(q, k, positions, li, cfg)

    attn = attn_core(q, k, v, li).reshape(*lead, s, -1)
    x = llm_model._attn_residual(x, attn, layer, cfg)
    if mlp_fn is None:
        flat = x.reshape(-1, x.shape[-1])
        return llm_model._mlp(flat, layer, cfg, li).reshape(x.shape), None
    return mlp_fn(x, layer)
