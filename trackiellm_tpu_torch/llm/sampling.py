"""Token sampling: repetition penalty, masks, min-p, temperature, top-k,
top-p, and greedy argmax.

Port of ``trackiellm_tpu/llm/sampling.py`` (``sample``, ``_process_chain``,
``greedy``). Randomness comes from an explicit ``torch.Generator`` on the
logits' device; its stream differs from ``jax.random``'s, so the port is
held to the same distribution, not the same draws. Speculative
verification (``spec_verify_sampled``) waits for the speculation port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _process_chain(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float, min_p: float,
                   mask: Optional[torch.Tensor],
                   recent_tokens: Optional[torch.Tensor],
                   repetition_penalty: float) -> torch.Tensor:
    """llama.cpp's order: repetition penalty -> mask -> min-p (on the
    pre-temperature distribution) -> temperature -> top-k -> top-p.
    Returns the final logits that the categorical draw uses."""
    logits = logits.float()
    v = logits.shape[0]
    if recent_tokens is not None and repetition_penalty != 1.0:
        idx = torch.where(recent_tokens >= 0, recent_tokens,
                          torch.full_like(recent_tokens, v)).long()
        seen = torch.bincount(idx, minlength=v + 1)[:v] > 0
        penalized = torch.where(logits > 0, logits / repetition_penalty,
                                logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if min_p > 0.0:
        keep = (logits - logits.max()) >= math.log(min_p)
        logits = torch.where(keep, logits, NEG_INF)
    logits = logits / max(temperature, 1e-6)
    if 0 < top_k < v:
        kth = torch.topk(logits, top_k).values[-1]
        logits = torch.where(logits >= kth, logits, NEG_INF)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens while the exclusive cumulative prob is < top_p.
        cutoff_idx = ((cum - probs) < top_p).sum() - 1
        cutoff = sorted_logits[cutoff_idx.clamp_min(0)]
        logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float, top_k: int = 40, top_p: float = 0.95,
           min_p: float = 0.0, mask: Optional[torch.Tensor] = None,
           recent_tokens: Optional[torch.Tensor] = None,
           repetition_penalty: float = 1.0) -> torch.Tensor:
    """Draw one token id (0-d int64 tensor on the logits' device)."""
    final = _process_chain(logits, temperature, top_k, top_p, min_p, mask,
                           recent_tokens, repetition_penalty)
    probs = torch.softmax(final, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[0]


def greedy(logits: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return torch.argmax(logits)
